"""K1, the mesh-array GEMM (`kernels/mesh_matmul.py`): the roofline bound
of the dense products that the profiled ticks' prefills and decode steps
need (`harness.work`; the head at the last prompt position and at each
active slot only) over the device time of the `mesh_*` kernels those
ticks ran.  Moves `ttft_p90_ms`."""

from portbench.harness import work

KERNELS = r"\bmesh_\w*kernel"


def read(run):
    if run.peaks is None or run.profile is None:
        return None
    ticks = run.ticks_in_profile()
    prefills = [s.attrs["tokens"] for s in run.within(ticks, "serve.prefill")]
    decodes = [s.attrs["slots"] for s in run.within(ticks, "serve.decode")]
    seconds, launches = run.ops_in(ticks, KERNELS)
    per = len(work.layer_products(run.cfg)) * run.cfg.num_layers + 1
    run.note(f"[k1_roofline.serve] {len(ticks)} ticks: {len(prefills)} prefills,"
             f" {len(decodes)} decode steps; K1 launches seen {launches}, assumed"
             f" {per * (len(prefills) + len(decodes))}")
    if not seconds:
        return None
    bound = work.products_bound_s(work.serve_k1_products(run.cfg, prefills, decodes), run.peaks)
    return 100.0 * bound / seconds
