"""Cross entropy over full vocabulary logits.

Counterpart of `megatron_clip_tpu/ops/cross_entropy.py::cross_entropy`, plain
PyTorch (not a kernel there either). Under tensor parallelism the loss
runs on each rank's own rows with the head gathered whole
(`models/gpt.py::gpt_loss`), as XLA feeds its custom calls whole; the
vocab-parallel form (`vocab_parallel_cross_entropy`) stays in ROADMAP
Queue A item 4. The fused lm-head + cross-entropy kernel is `fused_ce`
(ROADMAP Queue B).
"""
import torch


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor, *,
                  label_smoothing: float = 0.0) -> torch.Tensor:
    """logits [..., V] (any dtype; promoted to fp32), targets [...] integer
    ids. Returns the per-position loss [...], logsumexp(logits) minus the
    target's logit; with `label_smoothing` eps, (1 - eps) of that minus eps
    times the mean log-probability over the vocabulary (torch's convention,
    without an eps*log(V) offset)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets[..., None].long())[..., 0]
    loss = logz - gold
    if label_smoothing > 0.0:
        mean_log = (logits - logz[..., None]).mean(-1)
        loss = (1 - label_smoothing) * loss - label_smoothing * mean_log
    return loss
