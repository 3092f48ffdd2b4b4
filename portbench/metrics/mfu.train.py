"""Whole training step (`train/train_step.py`): the operations the window's
steps need (`harness.work.train_step_flops`: six per product parameter
and token, attention three times its forward, no recomputation) over the
window's time times the card's bf16 peak.  Moves `train_tokens_per_s`."""

from portbench.harness import work


def read(run):
    if run.peaks is None or not run.window_s:
        return None
    flops = work.train_step_flops(run.cfg, run.rows, run.seq_len) * run.steps
    return 100.0 * flops / (run.window_s * run.peaks["bf16_flops_per_s"])
