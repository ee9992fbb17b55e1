"""cli/pde_check on every family against the JAX package's: the task and
validation points the JAX CLI draws (PRNGKey(0) split in three) go into
the port's run(), whose own ground truth must give the JAX CLI's gt_norm
within 1e-3 relative, with its JSON keys."""

import jax
import numpy as np
import pytest
import torch

from metapde_tpu.cli import pde_check as j_pde_check
from metapde_tpu.config import Config as JConfig
from metapde_tpu.config import parse_overrides as j_parse_overrides
from metapde_tpu.pdes import get_pde as j_get_pde
from metapde_tpu_torch.cli import pde_check
from metapde_tpu_torch.config import Config, parse_overrides

torch.set_num_threads(2)

FAMILIES = {
    "poisson": ["--task.pde=poisson"],
    "td_burgers": ["--task.pde=td_burgers", "--task.num_tsteps=11"],
    "hyper_elasticity": ["--task.pde=hyper_elasticity", "--task.max_holes=3",
                         "--task.max_hole_size=0.5", "--task.domain.xmin=0",
                         "--task.domain.ymin=0"],
    "steady_burgers": ["--task.pde=steady_burgers", "--task.max_hole_size=0.3",
                       "--task.max_reynolds=10"],
    "poisson3d": ["--task.pde=poisson3d"],
}
RESOLUTION = {"poisson": 8, "td_burgers": 64, "hyper_elasticity": 8, "steady_burgers": 12,
              "poisson3d": 8}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_gt_norm_equals_the_jax_clis(tmp_path, family):
    flags, res = FAMILIES[family], RESOLUTION[family]
    j_cfg = j_parse_overrides(JConfig(), flags)
    want = j_pde_check.run(j_cfg, out=str(tmp_path / "jax"), resolution=res)
    pde = j_get_pde(j_cfg.task)
    k1, _, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = pde.sample_params(k1)
    xs = pde.sample_validation_points(k3, 2048, params, pde.solve(params, resolution=res))
    got = pde_check.run(parse_overrides(Config(), flags), out=str(tmp_path / "port"),
                        resolution=res, device="cpu",
                        params=tuple(torch.tensor(np.asarray(a)) for a in params),
                        xs=torch.tensor(np.asarray(xs)))
    assert set(got) == set(want)
    assert got["pde"] == want["pde"] and got["n_point_sets"] == want["n_point_sets"]
    assert got["gt_finite"] is True
    assert got["gt_norm"] == pytest.approx(want["gt_norm"], rel=1e-3)


def test_draws_its_own_task(tmp_path):
    stats = pde_check.main(["--device=cpu", "--task.pde=poisson", f"--out={tmp_path}",
                            "--resolution=4", "--seed=3"])
    assert stats["gt_finite"] and stats["gt_norm"] > 0
