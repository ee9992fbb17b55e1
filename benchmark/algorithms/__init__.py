"""The program under test, one module a meta-learner, found by the
configuration's "algorithm": how to build it, drive its timed call and
read its state."""
