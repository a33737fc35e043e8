"""Plain DualAR forward in float32, teacher-forced over a served sequence.

The published OpenAudio S1-mini LM: a slow decoder stack over text and
semantic tokens (pre-norm RMSNorm, grouped-query attention with
interleaved rotary positions, SwiGLU), a final RMSNorm and a head tied to
the token embedding; then per frame a fast stack over the codebooks,
started from the slow stack's hidden state before its final norm, each
book's input the embedding of the code before it.  A frame's input to the
slow stack is its token's embedding plus, when the token is semantic, the
sum of its codes' codebook embeddings.

Weights are the harness's seeded tensors; this module works out anything
derived from them (a weight-only int8 or int4 copy, an fp8 copy) itself.
Every product runs in float32 with TF32 off.  ``mode``:

- ``"bf16"`` / ``"fp32"``: the weights as they are;
- ``"int8"`` / ``"int4"``: the matrices and embedding tables quantized
  per output row, symmetric, round half to even (``max|w| / 127`` or
  ``/ 7``);
- ``"fp8"``: the matrices per row and every product's input per row in
  float8 e4m3;
- ``"w8a8"``: the matrices and tables as ``"int8"``, and every product's
  input per row in int8 (symmetric, ``max|x| / 127``).
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import sampling as S

# What this reference computes: the model keys it reads as sizes, and the
# flags it computes at the one value each may take.  The harness refuses a
# configuration whose ``model`` holds another key or another value
# (``check.refuse``).
SIZES = ("vocab_size", "n_layer", "n_head", "n_local_heads", "dim", "head_dim",
         "intermediate_size", "rope_base", "norm_eps", "max_seq_len", "codebook_size",
         "num_codebooks", "n_fast_layer", "fast_dim", "fast_n_head", "fast_n_local_heads",
         "fast_head_dim", "fast_intermediate_size", "residual_codebook_size")
FLAGS = {"model_type": "dual_ar", "tie_word_embeddings": True, "attention_qkv_bias": False,
         "attention_o_bias": False, "attention_qk_norm": False,
         "fast_attention_qkv_bias": False, "fast_attention_o_bias": False,
         "fast_attention_qk_norm": False, "scale_codebook_embeddings": False}

QUANT_KEYS = ("wqkv", "wo", "w1", "w3", "w2")
FP8_MAX = 448.0
WEIGHTS = {"w8a8": "int8"}  # a mode's rounding of the weights, where it has its own name
INPUTS = {"fp8": "fp8", "w8a8": "int8"}  # a mode's rounding of each product's input


def f32_only() -> None:
    """Float32 products in full precision on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def qdq(w: torch.Tensor, mode: str) -> torch.Tensor:
    """``w`` (..., rows, cols) rounded as ``mode`` stores it, in float32:
    one scale per row over the last axis."""
    w = w.float()
    if mode in ("bf16", "fp32"):
        return w
    amax = w.abs().amax(dim=-1, keepdim=True)
    if mode == "fp8":
        scale = torch.clamp(amax, min=1e-30) / FP8_MAX
        return (w / scale).to(torch.float8_e4m3fn).float() * scale
    qmax = {"int8": 127.0, "int4": 7.0}[mode]
    scale = torch.clamp(amax, min=1e-8) / qmax
    return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale


def _rms(x: torch.Tensor, g: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * g


def rope(n: int, head_dim: int, base: float, device) -> tuple[torch.Tensor, torch.Tensor]:
    inv = base ** (-torch.arange(0, head_dim, 2, dtype=torch.float64) / head_dim)
    ang = torch.arange(n, dtype=torch.float64)[:, None] * inv[None]
    return torch.cos(ang).float().to(device), torch.sin(ang).float().to(device)


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., N, H, Dh) with pairs (2i, 2i+1) rotated by position."""
    xr, xi = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None], sin[:, None]
    return torch.stack([xr * c - xi * s, xi * c + xr * s], dim=-1).flatten(-2)


class Stack:
    """One decoder stack's layers in float32, as ``mode`` rounds them."""

    def __init__(self, layers: dict, n_head: int, n_kv: int, head_dim: int, eps: float,
                 mode: str):
        self.n_head, self.n_kv, self.head_dim, self.eps = n_head, n_kv, head_dim, eps
        self.inputs = INPUTS.get(mode)
        wmode = WEIGHTS.get(mode, mode)
        n = layers["attention_norm"].shape[0]
        self.layers = [{k: (qdq(v[i], wmode) if k in QUANT_KEYS else v[i].float())
                        for k, v in layers.items()} for i in range(n)]

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.inputs:
            x = qdq(x, self.inputs)
        return x @ w.T

    def __call__(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
        """x (B, N, D) causal over N -> (B, N, D)."""
        B, N, _ = x.shape
        H, Hkv, Dh = self.n_head, self.n_kv, self.head_dim
        causal = torch.full((N, N), float("-inf"), device=x.device).triu(1)
        for lp in self.layers:
            h = _rms(x, lp["attention_norm"], self.eps)
            qkv = self.mm(h, lp["wqkv"])
            q, k, v = qkv.split([H * Dh, Hkv * Dh, Hkv * Dh], dim=-1)
            q = _rotate(q.reshape(B, N, H, Dh), cos, sin)
            k = _rotate(k.reshape(B, N, Hkv, Dh), cos, sin)
            v = v.reshape(B, N, Hkv, Dh)
            q = q.reshape(B, N, Hkv, H // Hkv, Dh)
            s = torch.einsum("bqhgd,bkhd->bhgqk", q, k) / math.sqrt(Dh) + causal
            o = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(s, dim=-1), v)
            x = x + self.mm(o.reshape(B, N, H * Dh), lp["wo"])
            f = _rms(x, lp["ffn_norm"], self.eps)
            g = self.mm(f, lp["w1"])
            x = x + self.mm(g * torch.sigmoid(g) * self.mm(f, lp["w3"]), lp["w2"])
        return x


class DualAR:
    """The LM of ``cfg`` (a configuration file's sizes) on ``params``."""

    def __init__(self, params: dict, cfg: dict, ids, mode: str):
        f32_only()
        self.cfg, self.ids, self.mode = cfg, ids, mode
        wmode = WEIGHTS.get(mode, mode)
        quant = wmode not in ("bf16", "fp32")
        self.emb = qdq(params["embeddings"], wmode) if quant else params["embeddings"].float()
        self.cb_emb = (qdq(params["codebook_embeddings"], wmode) if quant
                       else params["codebook_embeddings"].float())
        self.fast_emb = (qdq(params["fast_embeddings"], wmode) if quant
                         else params["fast_embeddings"].float())
        self.fast_out = qdq(params["fast_output"], wmode)[:cfg["residual_codebook_size"]]
        self.norm, self.fast_norm = params["norm"].float(), params["fast_norm"].float()
        self.slow = Stack(params["layers"], cfg["n_head"], cfg["n_local_heads"],
                          cfg["head_dim"], cfg["norm_eps"], mode)
        self.fast = Stack(params["fast_layers"], cfg["fast_n_head"],
                          cfg["fast_n_local_heads"], cfg["fast_head_dim"], cfg["norm_eps"],
                          mode)
        dev = self.norm.device
        self.slow_rope = rope(cfg["max_seq_len"], cfg["head_dim"], cfg["rope_base"], dev)
        self.fast_rope = rope(cfg["num_codebooks"], cfg["fast_head_dim"], cfg["rope_base"], dev)

    def embed(self, inp: torch.Tensor) -> torch.Tensor:
        """inp (1+K, N) int64 -> (1, N, D)."""
        K, cb = self.cfg["num_codebooks"], self.cfg["codebook_size"]
        tok = inp[0]
        x = self.emb[tok]
        offsets = torch.arange(K, device=inp.device)[:, None] * cb
        vq = self.cb_emb[inp[1:] + offsets].sum(dim=0)
        semantic = (tok >= self.ids.semantic_begin) & (tok <= self.ids.semantic_end)
        return (x + torch.where(semantic[:, None], vq, torch.zeros_like(vq)))[None]

    def hidden(self, inp: torch.Tensor) -> torch.Tensor:
        """The slow stack's output before its final norm, (N, D)."""
        n = inp.shape[1]
        cos, sin = (t[:n] for t in self.slow_rope)
        return self.slow(self.embed(inp), cos, sin)[0]

    def head(self, h: torch.Tensor) -> torch.Tensor:
        """(n, D) hidden -> (n, V) logits of the tied head."""
        return self.slow.mm(_rms(h, self.norm, self.cfg["norm_eps"]), self.emb)

    def fast_logits(self, h: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
        """h (F, D) a frame's hidden, codes (F, K) its codes -> (F, K-1, Vr):
        book b's logits, given the codes before it."""
        x = torch.cat([h[:, None], self.fast_emb[codes[:, :-1]]], dim=1)
        x = self.fast(x, *self.fast_rope)
        return self.fast.mm(_rms(x[:, 1:], self.fast_norm, self.cfg["norm_eps"]),
                            self.fast_out)


@torch.no_grad()
def served_gaps(ref: DualAR, prompt: torch.Tensor, frames: torch.Tensor,
                chooser: DualAR | None = None, block: int = 256) -> dict:
    """Teacher-force ``ref`` over ``prompt`` (1+K, T) and the served
    ``frames`` (F, 1+K) [token, codes], and read, at every position, by how
    much the chosen token's logit lies below ``ref``'s best: the served
    token's, or with a ``chooser`` the token that the chooser, fed the same
    prompt and frames, puts first.  Returns the widest gap of the slow
    tokens and of the residual codes, the sum of every gap and how many
    tokens were read."""
    T, F = prompt.shape[1], frames.shape[0]
    inp = torch.cat([prompt, frames[:-1].T], dim=1)
    h = ref.hidden(inp)[T - 1:T - 1 + F]
    hc = None if chooser is None else chooser.hidden(inp)[T - 1:T - 1 + F]
    slow = fast = total = 0.0
    for a in range(0, F, block):
        lr = ref.head(h[a:a + block])
        tok = (frames[a:a + block, 0] if hc is None
               else chooser.head(hc[a:a + block]).argmax(dim=-1))
        gap = lr.max(dim=-1).values - lr.gather(1, tok[:, None])[:, 0]
        slow, total = max(slow, float(gap.max())), total + float(gap.sum())
    for a in range(0, F, block):
        codes = frames[a:a + block, 1:]
        lr = ref.fast_logits(h[a:a + block], codes)
        chosen = (codes[:, 1:] if hc is None
                  else chooser.fast_logits(hc[a:a + block], codes).argmax(dim=-1))
        gap = lr.max(dim=-1).values - lr.gather(2, chosen[..., None])[..., 0]
        fast, total = max(fast, float(gap.max())), total + float(gap.sum())
    return {"slow_gap": slow, "fast_gap": fast, "gap_sum": total,
            "tokens": F * (frames.shape[1] - 1)}


@torch.no_grad()
def sampled_gaps(ref: DualAR, prompt: torch.Tensor, frames: torch.Tensor, key: int,
                 rules: dict, chooser: DualAR | None = None, block: int = 64) -> dict:
    """As :func:`served_gaps`, for a request that samples: at every position,
    by how much the served token (or the one that ``chooser`` draws by the
    same rules, from the same noise) falls short of ``ref``'s own draw by
    the sampler's rules (``sampling.gap``): the repetition penalty over the
    served frames' window, the nucleus, the temperature and the request's
    noise (``key``).  Returns the widest gap of the slow tokens and of the
    residual codes, the sum of every gap and how many tokens were read,
    and the largest mass that ``ref`` puts on tokens that are not semantic
    (where the served codes could not name the token)."""
    T, F = prompt.shape[1], frames.shape[0]
    temp, top_p, rep = rules["temperature"], rules["top_p"], rules["repetition_penalty"]
    V, Vr, K = ref.cfg["vocab_size"], ref.cfg["residual_codebook_size"], ref.cfg["num_codebooks"]
    inp = torch.cat([prompt, frames[:-1].T], dim=1)
    h = ref.hidden(inp)[T - 1:T - 1 + F]
    hc = None if chooser is None else chooser.hidden(inp)[T - 1:T - 1 + F]
    slow = fast = text = total = 0.0
    semantic = torch.zeros(V, dtype=torch.bool, device=h.device)
    semantic[ref.ids.semantic_begin:ref.ids.semantic_end + 1] = True
    for a in range(0, F, block):
        n = min(block, F - a)
        steps = S.steps_of(a, n, h.device)
        pen = S.penalties(a, n, rep, h.device)
        ids = S.slow_penalty_ids(frames, a, n)
        noise = S.gumbel(key, steps, 0, V)
        lr = S.penalise(ref.head(h[a:a + n]), ids, pen)
        tok = (frames[a:a + n, 0] if hc is None else
               S.pick(S.penalise(chooser.head(hc[a:a + n]), ids, pen), noise, temp, top_p))
        g = S.gap(lr, noise, temp, top_p, tok)
        slow, total = max(slow, float(g.max())), total + float(g.sum())
        text = max(text, float(torch.softmax(lr, dim=-1)[:, ~semantic].sum(dim=-1).max()))
        codes = frames[a:a + n, 1:]
        lf = ref.fast_logits(h[a:a + n], codes)
        cf = None if hc is None else chooser.fast_logits(hc[a:a + n], codes)
        for b in range(1, K):
            ids = S.book_penalty_ids(frames, b, a, n)
            noise = S.gumbel(key, steps, V + (b - 1) * Vr, Vr)
            lb = S.penalise(lf[:, b - 1], ids, pen)
            tok = (codes[:, b] if cf is None else
                   S.pick(S.penalise(cf[:, b - 1], ids, pen), noise, temp, top_p))
            g = S.gap(lb, noise, temp, top_p, tok)
            fast, total = max(fast, float(g.max())), total + float(g.sum())
    return {"slow_gap": slow, "fast_gap": fast, "gap_sum": total, "tokens": F * K,
            "text_mass": text}
