"""Reference task families, one module each, found by the pde's name."""
