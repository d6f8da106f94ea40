"""Oracle for flash attention: plain softmax attention over the whole
(S, S) score matrix, as the JAX oracle computes it (causal mask −1e30).

Used by tests and checks only; the port's path never calls it.  On the card
the caller turns TF32 off (``torch.backends.cuda.matmul.allow_tf32``)."""
import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q, k: (..., S, D); v: (..., S, Dv); scale 1/√D."""
    d = q.shape[-1]
    s = torch.einsum("...qd,...kd->...qk", q, k).float() / (d ** 0.5)
    if causal:
        sl = q.shape[-2]
        mask = torch.tril(torch.ones((sl, sl), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("...qk,...kd->...qd", p, v)
