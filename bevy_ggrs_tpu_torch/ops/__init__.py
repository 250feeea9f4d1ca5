"""Hand-written CUDA kernels and their wrappers."""


def wrappers() -> tuple:
    """Every CUDA kernel's wrapper: the checksum first, then the four force
    kernels. Each wrapper's ``launches`` counts its kernel's launches."""
    from bevy_ggrs_tpu_torch.ops import cell_gather, checksum, pairwise

    return (checksum.world_checksum, pairwise.pairwise_force_rows,
            pairwise.pairwise_force_rows_mxu2, pairwise.pairwise_force_square_mxu_tri,
            cell_gather.cell_slot_forces)


def launch_counts() -> dict:
    """Launches so far in this process of each CUDA kernel's wrapper, by
    wrapper name. A wrapper counts where it launches its kernel, never when
    a CPU tensor takes its plain version."""
    return {fn.__name__: int(fn.launches) for fn in wrappers()}


def add_launches(counts: dict) -> None:
    """Add ``counts`` (by wrapper name, as :func:`launch_counts` gives them)
    to the wrappers' ``launches``: a CUDA graph's replay launches the kernels
    it captured without calling their wrappers, and its capture launches
    none though the wrappers ran."""
    for fn in wrappers():
        fn.launches += int(counts.get(fn.__name__, 0))
