"""filter_device_ms: device ms per op in the lattice kernels (K1, K2, the join rows, K3 and K9, K3'a-d, K3'c
transposed, K5, K8), summed by kernel name from the trace."""

from gpbench.readers import device_ms

KERNELS = (
    "geometry_kernel", "geometry_team_kernel",  # K1
    "insert_kernel", "fill_kernel", "fill_int_kernel", "seg_kernel", "neighbors_kernel",  # K2
    "first_kernel", "flag_kernel", "remap_kernel",
    "rows_pack_kernel", "join_runs_kernel", "join_rows_kernel", "sgp_run_lists_kernel",  # the join rows
    "splat_kernel", "blur_kernel", "slice_kernel", "slice_blocks_kernel", "sgp_blur_axes_kernel",  # K3, K9
    "sgp_live_blur_kernel",
    "chain_dedup_kernel", "chain_unique_rank_kernel", "chain_contrib_rank_kernel", "chain_place_kernel",  # K3'a
    "chain_rows_kernel", "chain_taps_kernel", "chain_gather_kernel",
    "chain_splat_kernel", "chain_combine_kernel",  # K3'b
    "chain_axes_kernel", "chain_axis_kernel", "chain_maps_kernel", "chain_unblock_kernel",  # K3'c and its transpose
    "chain_slice_kernel",  # K3'd
    "filter_grad_kernel",  # K5
    "count_kernel",  # K8
)


def read(ctx):
    return device_ms(ctx, KERNELS)
