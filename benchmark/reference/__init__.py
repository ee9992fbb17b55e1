"""The benchmark's plain reference: plain PyTorch, independent of the
program under test, which it never imports."""
