"""The comparisons that decide `correct`, against the plain reference.

Serving: the widest gap by which a served token's logit lies below the
best logit of the float32 reference at that position, over a sample of
the requests served in the window (the reference runs each prompt with
its served tokens once).  The control puts the reference in the
program's place at the precision below (float8 e4m3): at each position
it takes the token that the float8 logits put first and reads that
token's gap in the float32 logits.

Training: the reference runs the program's first three steps from the
same weights on the same rows in float32 (AdamW with the program's
hyper-parameters, global-norm clipping, weight decay on leaves of two or
more dims), and three numbers are compared: each step's loss (relative
gap), the norm of the first gradient as the optimizer gets it (after
clipping; the program's is read from its first moment after step 1,
m / (1 - b1)), and the norm of each leaf's change over the three steps,
both by the worst leaf: |program - reference| over the larger of the
reference's norm of that leaf and of the median leaf.  A leaf whose
reference gradient is under a thousandth of the median leaf's (a key
bias under softmax: round-off alone moves it under Adam) is left out.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference import model as ref


def reference_precision() -> None:
    """float32 products in float32: no TF32 anywhere in the process."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sample_requests(done: Sequence[Tuple[np.ndarray, List[int]]], seed: int,
                    want_tokens: int) -> List[int]:
    """Indices into `done` (prompt, served tokens) drawn from the seed: the
    longest request first, then others at random until `want_tokens`
    served tokens are in the sample."""
    if not done:
        return []
    sizes = [len(p) + len(t) for p, t in done]
    first = int(np.argmax(sizes))
    rest = [i for i in np.random.default_rng(seed).permutation(len(done)) if i != first]
    picked, tokens = [first], len(done[first][1])
    for i in rest:
        if tokens >= want_tokens:
            break
        picked.append(int(i))
        tokens += len(done[i][1])
    return picked


def _sequences(samples, device):
    seqs, rows = [], []
    for prompt, toks in samples:
        t, n = len(prompt), len(toks)
        seq = np.concatenate([np.asarray(prompt, np.int64), np.asarray(toks[:-1], np.int64)])
        seqs.append(torch.as_tensor(seq, device=device))
        rows.append((t - 1, t - 1 + n))
    return seqs, rows


def served_token_gap(params, cfg, samples, *, control: bool = False) -> Tuple[float, int]:
    """(widest gap, tokens compared) of the served tokens of `samples`
    [(prompt, tokens)]; with `control`, of the tokens the float8 reference
    puts first at the same positions."""
    if not samples:
        return float("nan"), 0
    device = params["embed"].device
    seqs, rows = _sequences(samples, device)
    exact = ref.served_logits(params, cfg, seqs, rows)
    picks = ([torch.argmax(x, dim=-1) for x in ref.served_logits(params, cfg, seqs, rows, fp8=True)]
             if control else
             [torch.as_tensor(np.asarray(t, np.int64), device=device) for _, t in samples])
    worst, count = 0.0, 0
    for lg, tok in zip(exact, picks):
        lg = lg[:, :cfg.vocab_size]
        gap = lg.max(dim=-1).values - lg.gather(1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
        count += int(tok.numel())
    return worst, count


def flat(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: leaf} of a nested dict of tensors, in its order."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}.{k}" if prefix else k
        out.update(flat(v, path) if isinstance(v, dict) else {path: v})
    return out


def unflat(named: Dict[str, torch.Tensor]):
    """The nested dict of `flat`'s {path: leaf}."""
    out: Dict = {}
    for path, x in named.items():
        *head, last = path.split(".")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = x
    return out


def leaf_norms(tree, fn: Callable[[str, torch.Tensor], torch.Tensor] = None) -> Dict[str, float]:
    """{path: float32 norm of each leaf (or of fn(path, leaf))}."""
    with torch.no_grad():
        return {p: float(torch.linalg.vector_norm((x if fn is None else fn(p, x)).float()))
                for p, x in flat(tree).items()}


def reference_steps(params_f32, batches, cfg, hp: Dict[str, float], *, fp8: bool = False,
                    rows=None) -> Dict[str, object]:
    """The reference's steps on `batches` from `params_f32` (a tree of
    float32 leaves, updated in place): losses, the first step's clipped
    gradient norms."""
    named = flat(params_f32)
    paths, leaves = list(named), list(named.values())
    for p in leaves:
        p.requires_grad_(True)
    m = [torch.zeros_like(p) for p in leaves]
    v = [torch.zeros_like(p) for p in leaves]
    b1, b2, eps, wd, clip, lr = (hp[k] for k in ("b1", "b2", "eps", "weight_decay", "clip_norm",
                                                  "lr"))
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        with torch.enable_grad():
            value = ref.loss(params_f32, batch, cfg, fp8=fp8, rows=rows)
            grads = torch.autograd.grad(value, leaves)
        losses.append(float(value.detach()))
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        scale = torch.clamp(clip / (norm + 1e-9), max=1.0)
        with torch.no_grad():
            for i, (g, p) in enumerate(zip(grads, leaves)):
                g = g * scale
                if step == 1:
                    first[paths[i]] = float(torch.linalg.vector_norm(g))
                m[i].mul_(b1).add_((1 - b1) * g)
                v[i].mul_(b2).add_((1 - b2) * g * g)
                upd = (m[i] / (1 - b1 ** step)) / (torch.sqrt(v[i] / (1 - b2 ** step)) + eps)
                if p.dim() >= 2:
                    upd = upd + wd * p
                p.sub_(lr * upd)
        del grads
    for p in leaves:
        p.requires_grad_(False)
    return {"losses": losses, "grad_norms": first}


def leaf_gaps(prog: Dict[str, float], refv: Dict[str, float], kept: Sequence[str]):
    """[(leaf, program, reference, gap)] of the `kept` leaves, widest gap
    first: |program - reference| over the larger of the leaf's reference
    norm and the median leaf's."""
    med = statistics.median(refv[p] for p in kept)
    rows = [(p, prog[p], refv[p], abs(prog[p] - refv[p]) / max(refv[p], med)) for p in kept]
    return sorted(rows, key=lambda r: -r[3])


def worst_leaf(prog: Dict[str, float], refv: Dict[str, float], kept: Sequence[str]) -> float:
    """The widest of `leaf_gaps`."""
    return leaf_gaps(prog, refv, kept)[0][3]


def kept_leaves(ref_grads: Dict[str, float]) -> List[str]:
    """Leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = statistics.median(ref_grads.values())
    return [p for p, g in ref_grads.items() if g >= 1e-3 * med]


def train_numbers(prog: Dict[str, object], refr: Dict[str, object]) -> Dict[str, float]:
    """The three compared numbers of a training cell."""
    kept = kept_leaves(refr["grad_norms"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], refr["losses"]))
    return {
        "loss_rel_gap": loss_gap,
        "grad_norm_gap": worst_leaf(prog["grad_norms"], refr["grad_norms"], kept),
        "change_norm_gap": worst_leaf(prog["change_norms"], refr["change_norms"], kept),
    }
