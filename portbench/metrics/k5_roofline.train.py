"""K5, the grouped expert GEMM (`kernels/grouped.py`), training: the
roofline bound of the profiled steps' routed-expert products, forward and
both gradients, for every (token, expert) pair the router chose
(`harness.work.grouped_bound_s`), over the device time of the
`grouped_*` kernels.  Moves `train_tokens_per_s`."""

from portbench.harness import work

KERNELS = r"\bgrouped_\w*kernel"


def read(run):
    if run.peaks is None or run.profile is None or not run.profiled_steps:
        return None
    if not run.cfg.is_moe:
        return None
    seconds, launches = run.profile.time_of(KERNELS)
    n = run.profiled_steps
    run.note(f"[k5_roofline.train] {n} profiled steps; K5 launches seen {launches}, assumed"
             f" {n * work.k5_launches_train(run.cfg)}")
    if not seconds:
        return None
    pairs = run.rows * run.seq_len * run.cfg.num_experts_per_tok
    bound = work.grouped_bound_s(run.cfg, pairs, run.peaks, backward=True)
    return 100.0 * n * bound / seconds
