"""A test's LM reference: the stand-ins' (``reference/dual_ar.py``) with
q/k-norm in the slow stack, and a weight draw that adds its gains.

Each head's query and key go through an RMSNorm over the head's width,
scaled by the layer's ``q_norm`` / ``k_norm`` (layers, head_dim), before
their rotary positions, as the port computes ``attention_qk_norm``.  The
gains are drawn near 1 (std 0.1), so that a reference that left them out
would read the program wrong.
"""

from __future__ import annotations

import math

import torch

from port_bench import weights
from port_bench.reference import dual_ar
from port_bench.reference.dual_ar import _rms, _rotate

SIZES = dual_ar.SIZES
FLAGS = {**dual_ar.FLAGS, "attention_qk_norm": True}


def lm_specs(cfg: dict) -> list:
    n, dh = cfg["n_layer"], cfg["head_dim"]
    return weights.lm_specs(cfg) + [(("layers", name), (n, dh), ("normal", 0.1, 1.0))
                                    for name in ("q_norm", "k_norm")]


class QKStack(dual_ar.Stack):
    """``dual_ar.Stack`` with each head's query and key normed."""

    def __call__(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        B, N, _ = x.shape
        H, Hkv, Dh = self.n_head, self.n_kv, self.head_dim
        causal = torch.full((N, N), float("-inf"), device=x.device).triu(1)
        for lp in self.layers:
            h = _rms(x, lp["attention_norm"], self.eps)
            q, k, v = self.mm(h, lp["wqkv"]).split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
            q = _rotate(_rms(q.reshape(B, N, H, Dh), lp["q_norm"], self.eps), cos, sin)
            k = _rotate(_rms(k.reshape(B, N, Hkv, Dh), lp["k_norm"], self.eps), cos, sin)
            v = v.reshape(B, N, Hkv, Dh)
            q = q.reshape(B, N, Hkv, H // Hkv, Dh)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(Dh) + causal
            o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
            x = x + self.mm(o.reshape(B, N, H * Dh), lp["wo"])
            f = _rms(x, lp["ffn_norm"], self.eps)
            g = self.mm(f, lp["w1"])
            x = x + self.mm(g * torch.sigmoid(g) * self.mm(f, lp["w3"]), lp["w2"])
        return x


class DualAR(dual_ar.DualAR):
    def __init__(self, params: dict, cfg: dict, ids, mode: str):
        super().__init__(params, cfg, ids, mode)
        self.slow = QKStack(params["layers"], cfg["n_head"], cfg["n_local_heads"],
                            cfg["head_dim"], cfg["norm_eps"], mode)
