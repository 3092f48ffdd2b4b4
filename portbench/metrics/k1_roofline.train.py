"""K1, the mesh-array GEMM (`kernels/mesh_matmul.py`), training: the
roofline bound of the profiled steps' dense products, forward and both
gradients (`harness.work`), over the device time of the `mesh_*` kernels.
Moves `train_tokens_per_s`."""

from portbench.harness import work

KERNELS = r"\bmesh_\w*kernel"


def read(run):
    if run.peaks is None or run.profile is None or not run.profiled_steps:
        return None
    seconds, launches = run.profile.time_of(KERNELS)
    n = run.profiled_steps
    run.note(f"[k1_roofline.train] {n} profiled steps; K1 launches seen {launches}, assumed"
             f" {n * work.k1_launches_train(run.cfg)}")
    if not seconds:
        return None
    m = run.rows * run.seq_len
    bound = work.products_bound_s(work.forward_products(run.cfg, m, m), run.peaks, backward=True)
    return 100.0 * n * bound / seconds
