"""K6, flash attention (`kernels/flash_attention.py`), training: the
roofline bound of the profiled steps' causal attention forward (QKᵀ and
PV over the keys each query sees; q, k, v read and the output written
once) over the device time of the `flash_*` kernels.  The backward
recomputes attention in plain PyTorch, outside K6, so only the forward
is counted here; the `dots` and `full` remat policies run K6 again in
the backward's recompute, time the share counts as waste.  Moves
`train_tokens_per_s`."""

from portbench.harness import work

KERNELS = r"\bflash_\w*kernel"


def read(run):
    if run.peaks is None or run.profile is None or not run.profiled_steps:
        return None
    seconds, launches = run.profile.time_of(KERNELS)
    n = run.profiled_steps
    again = run.cfg.remat_policy in ("dots", "full")
    run.note(f"[k6_roofline.train] {n} profiled steps; K6 launches seen {launches}, assumed"
             f" {n * run.cfg.num_layers} forward + {n * run.cfg.num_layers * again} recompute")
    if not seconds:
        return None
    flops = run.rows * work.attention_flops(run.cfg, run.seq_len)
    nbytes = work.attention_bytes(run.cfg, run.rows, run.seq_len)
    bound = work.bound_s(flops, nbytes, run.peaks)
    return 100.0 * n * bound / seconds
