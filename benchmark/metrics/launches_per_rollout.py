"""Device operations (kernels, copies and sets) a rollout, counted in the
profiler's trace of the window."""


def read(w):
    return w.ops_per_unit()
