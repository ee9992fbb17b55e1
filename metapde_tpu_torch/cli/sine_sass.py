"""Count the SASS instructions of one sine: IEEE ``sinf`` against the
kernel's own ``sin_reduced`` (csrc/siren_fused.cu).

    python -m metapde_tpu_torch.cli.sine_sass

Builds two probe kernels, each one sine per thread, for sm_90a with the
kernel's nvcc flags, disassembles them with ``cuobjdump -sass`` and prints
one JSON line per probe: the instructions of its fast path (an argument of
magnitude below 8192: from the load of the argument to the store of the
result, taking the first conditional branch, convergence markers left out)
and the count of every instruction of the probe. Needs the CUDA toolkit;
no device.
"""

import json
import re
import subprocess
import tempfile
from pathlib import Path

from metapde_tpu_torch.ops import _build

PROBES = """
#include "siren_fused.cu"
extern "C" __global__ void sinf_probe(float* v) { v[threadIdx.x] = sinf(v[threadIdx.x]); }
extern "C" __global__ void sin_reduced_probe(float* v) {
  v[threadIdx.x] = sin_reduced(v[threadIdx.x]);
}
"""
NOT_COUNTED = ("NOP", "BSSY", "BSYNC")


def sass(source: str) -> str:
    """cuobjdump -sass of `source` built for sm_90a with the kernel's flags."""
    nvcc = _build._nvcc()
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC",
                                                        "-Xptxas", "-v")]
    with tempfile.TemporaryDirectory() as tmp:
        src, cubin = Path(tmp) / "probe.cu", Path(tmp) / "probe.cubin"
        src.write_text(source)
        subprocess.run([nvcc, *flags, "-I", str(_build.CSRC_DIR), "-cubin", "-o", str(cubin),
                        str(src)], check=True, timeout=120, capture_output=True)
        return subprocess.run([str(Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
                              check=True, timeout=60, capture_output=True, text=True).stdout


def instructions(listing: str, name: str):
    """[(address, instruction)] of the function `name` in a SASS listing."""
    body = listing.split(f"Function : {name}", 1)[1].split("Function :", 1)[0]
    return [(int(m.group(1), 16), m.group(2).strip())
            for m in re.finditer(r"/\*([0-9a-f]{4})\*/\s+([^;]*);", body)]


def fast_path(code):
    """The instructions run from the argument's load to the result's store
    when the first conditional branch is taken and no later one is."""
    at = {addr: i for i, (addr, _) in enumerate(code)}
    i = next(i for i, (_, ins) in enumerate(code) if ins.startswith("LDG")) + 1
    path, branched = [], False
    while not code[i][1].startswith("STG"):
        ins = code[i][1]
        if ins.split()[0] not in NOT_COUNTED:
            path.append(ins)
        target = re.match(r"(@!?U?P\d+ )?BRA (0x[0-9a-f]+)", ins)
        if target and (target.group(1) is None or not branched):
            branched = branched or target.group(1) is not None
            i = at[int(target.group(2), 16)]
        else:
            i += 1
    return path


def main():
    listing = sass(PROBES)
    for name in ("sinf_probe", "sin_reduced_probe"):
        code = instructions(listing, name)
        path = fast_path(code)
        print(json.dumps({"probe": name, "fast_path_instructions": len(path),
                          "all_instructions": sum(ins.split()[0] not in NOT_COUNTED
                                                  for _, ins in code),
                          "fast_path": path}), flush=True)


if __name__ == "__main__":
    main()
