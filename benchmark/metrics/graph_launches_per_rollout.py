"""CUDA graph launches a rollout: the ``cudaGraphLaunch`` runtime calls the
host made in the traced window, over the rollouts completed. 1 where
``SpeculativeExecutor.run`` replays a captured rollout, 0 where it
dispatches each operation on its own. Nothing without a device trace."""


def read(w):
    if not w.trace.ops or not w.units:
        return None
    return sum(name.startswith("cudaGraphLaunch") for _, _, name in w.trace.host) / w.units
