"""Mean host milliseconds until ``SpeculativeExecutor.run`` returns with
the card's queue empty when it starts: after the window, a few rollouts
each issued after a synchronize (the benchmark's span
``probe.speculate.run``). In the window itself the rollouts are dispatched
ahead and the launch queue is full, so ``run`` returns at the card's pace,
and its span would restate ``branch_frames_per_s``."""


def read(w):
    return w.spans.mean_ms("probe.speculate.run")
