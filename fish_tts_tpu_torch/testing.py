"""Bundles of random weights for ``FishTTS(_testing_bundle=...)``.

- ``make_tiny_bundle``: the tiny config and codec, a byte-level vocabulary
  with a reduced semantic range; CPU-sized, for the tests.
- ``make_s1_mini_bundle``: S1-mini widths and depth with the full-width
  codec and a byte-level vocabulary carrying the full special-token table,
  drawn from a seed on the given device in bf16.
- ``fast_decision_margins``: the fast decoder's codes against its plain
  version's, excusing a differing code only at a knife edge.
- ``slow_decision_margins``: the same for the slow-token sampler's tokens.
- ``sample_decision_margins``: the same for any sampler mode of
  ``engine/sampling`` (threshold, full sort, top-k), against logits that
  may each move by a tolerance.
- ``vq_decision_margins``: the codec encoder's codes against a reference
  encode's, excusing a differing code only where the reference's own
  float64 similarities of the two codebook entries nearly tie.
- ``s8_plain_trace`` and ``s8_decision_margins``: the fast decoder's
  ``"s8"`` mode against its plain version, row by quantized row, excusing
  a stream's later positions only from a row whose int8 values differ by
  one step at elements the plain version put at a rounding tie.
- ``to_reference_lm_state_dict`` / ``to_reference_codec_state_dict``: a
  bundle's parameters as the reference's ``model.pth`` / ``codec.pth``
  state dicts, the inverse of ``utils.checkpoint``'s converters;
  ``write_reference_dir`` writes a whole reference checkpoint directory.

Both write their ``.tiktoken`` vocabulary into a fresh temporary directory.
"""

from __future__ import annotations

import base64
import contextlib
import dataclasses
import json
import math
import tempfile
from pathlib import Path

import torch

from fish_tts_tpu_torch.config import (
    S1_MINI_CONFIG,
    TINY_CONFIG,
    TINY_VOCODER_CONFIG,
    VocoderConfig,
)
from fish_tts_tpu_torch.engine.sampling import candidate_width
from fish_tts_tpu_torch.models import dual_ar, vocoder
from fish_tts_tpu_torch.models.tokenizer import (
    ALL_SPECIAL_TOKENS,
    FishTokenizer,
    tiny_special_tokens,
    write_tiny_vocab,
)
from fish_tts_tpu_torch.ops import fast_decoder
from fish_tts_tpu_torch.ops.fast_decoder import NEG
from fish_tts_tpu_torch.ops.sampler_kernel import BISECT_ITERS


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def _byte_tokenizer(specials: list[str]) -> FishTokenizer:
    d = Path(tempfile.mkdtemp(prefix="fish_tts_torch_vocab_"))
    write_tiny_vocab(d / "tokenizer.tiktoken")
    return FishTokenizer(d / "tokenizer.tiktoken", specials)


def make_tiny_bundle(seed: int = 0):
    """(cfg, params, tokenizer, vocoder_cfg, vocoder_params) at tiny size,
    f32 on the CPU."""
    cfg, vcfg = TINY_CONFIG, TINY_VOCODER_CONFIG
    tokenizer = _byte_tokenizer(tiny_special_tokens(cfg.codebook_size))
    params = dual_ar.init_params(_generator(seed, "cpu"), cfg, dtype=torch.float32)
    vparams = vocoder.init_vocoder_params(_generator(seed + 1, "cpu"), vcfg,
                                          dtype=torch.float32)
    return cfg, params, tokenizer, vcfg, vparams


PAIRWISE_LANES = 4096  # up to this width the mass above each lane is summed pairwise


def _mass_above(l: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Per lane, the probability of the lanes whose logit is strictly
    larger: pairwise up to PAIRWISE_LANES lanes, beyond that (the slow
    token's 155 776) from one sort and a cumulative sum, ties taking the
    sum before their group."""
    if l.shape[-1] <= PAIRWISE_LANES:
        return torch.where(l[None, :] > l[:, None], p[None, :],
                           torch.zeros((), dtype=l.dtype)).sum(dim=-1)
    vals, idx = torch.sort(l, descending=True)
    before = torch.cumsum(p[idx], dim=0) - p[idx]
    first = torch.searchsorted(-vals, -vals, side="left")  # each tie group's first place
    return torch.empty_like(p).scatter_(0, idx, before[first])


def _knife_edge(logits: torch.Tensor, gumbel: torch.Tensor, temperature: float, top_p: float,
                i: int, k: int, tol: float) -> bool:
    """Whether logits that may each move by ``tol`` can turn the fast
    sampler's pick from lane ``i`` to lane ``k``, judged on one position's
    penalized ``logits`` (Vr,) of the reference: the two lanes' Gumbel
    scores lie within 2 tol / t of each other, or one of them sits within
    that movement of the top-p edge."""
    l = logits.double()
    t = max(temperature, 1e-5)
    p = torch.softmax(l, dim=-1)
    amax = l.max()
    mass = _mass_above(l, p) + p  # the pairwise rule keeps a lane iff mass <= top_p
    keep = (mass <= top_p) | (l >= amax) | (top_p >= 1.0)
    score = torch.where(keep, l, torch.full_like(l, NEG)) / t + gumbel.double()
    if keep[i] and keep[k] and abs(float(score[i] - score[k])) <= 2 * tol / t:
        return True
    if top_p >= 1.0:
        return False
    near_top = int((l >= amax - 2 * tol).sum())
    for lane in (i, k):
        # a shift of every logit by <= tol scales each probability by at most
        # e^(2 tol) and can move the lanes within 2 tol of this one across it
        near = (l - l[lane]).abs() <= 2 * tol
        delta = (math.exp(2 * tol) - 1) * float(mass[lane]) + float(p[near].sum() - p[lane])
        if abs(float(mass[lane]) - top_p) <= delta:
            return True
        if l[lane] >= amax - 2 * tol and near_top > 1:  # the argmax clause can change hands
            return True
    return False


def fast_decision_margins(codes, codes_plain, logits, logits_plain, gumbel, temperature,
                          top_p, tol: float) -> dict:
    """Hold the fast decoder's codes and logits against its plain version's,
    excusing a differing code only at a knife edge of the plain version.

    codes, codes_plain (B, K-1); logits, logits_plain (B, K-1, Vr) penalized;
    gumbel (B, K-1, Vr); temperature, top_p (B, 1) or scalars; ``tol`` the
    absolute logit tolerance.  Per stream, positions up to the first differing
    code must have logits within ``tol``; at that code the plain version's own
    numbers must show a knife edge (``_knife_edge``), and later positions are
    not compared, since their inputs differ.  Returns {"knife_edges": n,
    "failures": [messages], "max_abs_err": largest logit difference compared,
    "compared": positions compared}.
    """
    B, R = codes_plain.shape
    temp = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1).expand(B).tolist()
    tp = torch.as_tensor(top_p, dtype=torch.float32).reshape(-1).expand(B).tolist()
    codes, codes_plain = codes.cpu(), codes_plain.cpu()
    logits, logits_plain, gumbel = logits.cpu().float(), logits_plain.cpu().float(), gumbel.cpu()
    out = {"knife_edges": 0, "failures": [], "max_abs_err": 0.0, "compared": 0}
    for b in range(B):
        for r in range(R):
            err = float((logits[b, r] - logits_plain[b, r]).abs().max())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["compared"] += 1
            if not err <= tol:
                out["failures"].append(f"stream {b} position {r + 1}: logits differ by "
                                       f"{err:.3g} > {tol:.3g}")
                break
            want, got = int(codes_plain[b, r]), int(codes[b, r])
            if got == want:
                continue
            if _knife_edge(logits_plain[b, r], gumbel[b, r], temp[b], tp[b], want, got, tol):
                out["knife_edges"] += 1
            else:
                out["failures"].append(f"stream {b} position {r + 1}: code {got} != {want} "
                                       "with no knife edge in the reference")
            break
    return out


def _slow_trace(logits, prev_col, gumbel, temperature, top_p, repetition_penalty):
    """``sampler_kernel.sample_slow_plain``'s own numbers, by the same
    operations: the mass of each bisection step (B, BISECT_ITERS) and the
    perturbed values whose argmax is the token (B, V)."""
    V = logits.shape[1]
    lanes = torch.arange(V, device=logits.device)
    hit = (lanes[None, None, :] == prev_col.long()[:, :, None]).any(dim=1)
    rep = repetition_penalty
    l = torch.where(hit, torch.where(logits < 0, logits * rep, logits / rep), logits)
    amax = l.max(dim=-1, keepdim=True).values
    z = torch.log(torch.exp(l - amax).sum(dim=-1, keepdim=True)) + amax
    p = torch.exp(l - z)
    lo, hi = amax - 30.0, amax + 1.0
    zero = torch.zeros((), dtype=l.dtype, device=l.device)
    masses = []
    for _ in range(BISECT_ITERS):
        mid = 0.5 * (lo + hi)
        mass = torch.where(l >= mid, p, zero).sum(dim=-1, keepdim=True)
        masses.append(mass)
        take_hi = mass <= top_p
        lo, hi = torch.where(take_hi, lo, mid), torch.where(take_hi, mid, hi)
    thresh = torch.minimum(hi, amax)
    thresh = torch.where(top_p >= 1.0, torch.full_like(thresh, 0.5 * NEG), thresh)
    masked = torch.where(l >= thresh, l, torch.full_like(l, NEG))
    scores = masked / torch.clamp(temperature, min=1e-5) + gumbel
    return torch.cat(masses, dim=-1), scores


def slow_decision_margins(tokens, tokens_plain, logits, prev_col, gumbel, temperature, top_p,
                          repetition_penalty, tol: float = 1e-6) -> dict:
    """Hold the slow sampler's tokens against its plain version's, excusing a
    differing token only at a knife edge of the plain version's own numbers
    (the inputs as ``sample_slow`` takes them): one of its bisection masses
    lies within ``tol`` of top_p (top_p < 1), or its two largest perturbed
    values lie within ``tol``.  Returns {"knife_edges": n, "failures":
    [messages], "compared": rows}."""
    masses, scores = _slow_trace(logits, prev_col, gumbel, temperature, top_p,
                                 repetition_penalty)
    gap = (masses - top_p).abs().min(dim=-1).values.cpu()
    top2 = scores.topk(2, dim=-1).values.cpu()
    tp = top_p[:, 0].cpu()
    tokens, tokens_plain = tokens.cpu(), tokens_plain.cpu()
    out = {"knife_edges": 0, "failures": [], "compared": tokens_plain.shape[0]}
    for b in range(tokens_plain.shape[0]):
        got, want = int(tokens[b]), int(tokens_plain[b])
        if got == want:
            continue
        mass_edge = bool(tp[b] < 1.0) and float(gap[b]) <= tol
        if mass_edge or float(top2[b, 0] - top2[b, 1]) <= tol:
            out["knife_edges"] += 1
        else:
            out["failures"].append(f"row {b}: token {got} != {want} with no knife edge in the "
                                   f"reference (closest mass {float(gap[b]):.3g} from top_p)")
    return out


def _sort_knife_edge(logits: torch.Tensor, gumbel: torch.Tensor, temperature: float,
                     top_p: float, top_k: int, i: int, k: int, tol: float) -> bool:
    """``_knife_edge`` for the sort routes of ``engine/sampling``, whose noise
    lane follows a candidate's rank: logits that may each move by ``tol``
    can also swap the rank of lane ``i`` or ``k`` with a lane within 2 tol
    of it, and so their noise."""
    l = logits.double()
    for lane in (i, k):
        if int(((l - l[lane]).abs() <= 2 * tol).sum()) > 1:
            return True
    n = candidate_width(l.shape[0], top_k)
    order = torch.sort(l, descending=True, stable=True).indices[:n]
    per_lane = torch.full_like(l, float("-inf"))
    per_lane[order] = gumbel[:n].double()  # lanes beyond the candidates cannot be picked
    return _knife_edge(l, per_lane, temperature, top_p, i, k, tol)


def sample_decision_margins(tokens, tokens_ref, logits, gumbel, temperature, top_p,
                            top_k: int, tol: float) -> dict:
    """Hold tokens against a reference's, both from ``engine/sampling``'s rule
    for ``top_k`` (or the sampler kernel's, ``top_k = -1``), excusing a
    differing token only at a knife edge of the reference's own numbers:
    ``logits`` (B, V) penalized as the sampler saw them, ``gumbel`` (B, n)
    as it read them (by lane for ``top_k = -1``, by rank otherwise), ``tol``
    the absolute logit tolerance.  Returns {"knife_edges": n, "failures":
    [messages], "compared": rows}."""
    B = tokens_ref.shape[0]
    temp = torch.as_tensor(temperature, dtype=torch.float32).reshape(-1).expand(B).tolist()
    tp = torch.as_tensor(top_p, dtype=torch.float32).reshape(-1).expand(B).tolist()
    logits, gumbel = logits.cpu().float(), gumbel.cpu().float()
    out = {"knife_edges": 0, "failures": [], "compared": B}
    for b in range(B):
        got, want = int(tokens[b]), int(tokens_ref[b])
        if got == want:
            continue
        if top_k == -1:
            edge = _knife_edge(logits[b], gumbel[b, :logits.shape[1]], temp[b], tp[b], want,
                               got, tol)
        else:
            edge = _sort_knife_edge(logits[b], gumbel[b], temp[b], tp[b], top_k, want, got, tol)
        if edge:
            out["knife_edges"] += 1
        else:
            out["failures"].append(f"row {b}: token {got} != {want} with no knife edge in the "
                                   f"reference (top_k {top_k}, tol {tol:.3g})")
    return out


def make_s1_mini_bundle(seed: int = 0, device="cuda", with_vocoder: bool = True):
    """(cfg, params, tokenizer, vocoder_cfg, vocoder_params) at S1-mini
    widths with random bf16 weights on ``device``.  Without
    ``with_vocoder`` the codec parameters are None."""
    cfg, vcfg = S1_MINI_CONFIG, VocoderConfig()
    tokenizer = _byte_tokenizer(ALL_SPECIAL_TOKENS)
    params = dual_ar.init_params(_generator(seed, device), cfg, dtype=torch.bfloat16)
    vparams = None
    if with_vocoder:
        vparams = vocoder.init_vocoder_params(_generator(seed + 1, device), vcfg,
                                              dtype=torch.bfloat16)
    return cfg, params, tokenizer, vcfg, vparams


def vq_decision_margins(codes, codes_ref, qp, z_ref, margin: float) -> dict:
    """Hold encoded codes (B, 1+R, T) against a reference encode's.

    ``z_ref`` (B, C, T) is the reference's codebook input
    (``vocoder.quantizer_latent``) and ``qp`` the quantizer's parameters.
    Per frame the books are compared in order up to the first differing one
    (a different code changes the residual of every later book).  There the
    reference's own similarities, in float64, of its entry and the other
    one with the normalized projection of its residual must be within
    ``margin``.  Returns {"frames": frames compared, "near_ties": frames
    excused, "worst_gap": the largest similarity gap excused, "failures":
    [messages]}."""
    codes, codes_ref = codes.cpu().long(), codes_ref.cpu().long()
    z = z_ref.cpu().double()
    books = [{k: ({kk: vv.cpu().double() for kk, vv in v.items()} if isinstance(v, dict)
                  else v.cpu().double()) for k, v in vq.items()} for vq in vocoder.vq_books(qp)]
    out = {"frames": codes.shape[0] * codes.shape[2], "near_ties": 0, "worst_gap": 0.0,
           "failures": []}
    for b, t in (codes != codes_ref).any(dim=1).nonzero().tolist():
        j = int((codes[b, :, t] != codes_ref[b, :, t]).nonzero()[0])
        residual = z[b:b + 1, :, t:t + 1]
        for i in range(j):  # the books before j agree: the reference's residual
            residual = residual - vocoder._vq_embed_codes(books[i], codes_ref[b:b + 1, i, t:t + 1])
        e = vocoder._vq_in_proj(books[j], residual)[0, :, 0]
        e = e / (torch.linalg.vector_norm(e) + 1e-12)
        cb = books[j]["codebook"]
        sim = (cb / (torch.linalg.vector_norm(cb, dim=-1, keepdim=True) + 1e-12)) @ e
        want, got = int(codes_ref[b, j, t]), int(codes[b, j, t])
        gap = abs(float(sim[want] - sim[got]))
        if gap <= margin:
            out["near_ties"] += 1
            out["worst_gap"] = max(out["worst_gap"], gap)
        else:
            out["failures"].append(f"stream {b} frame {t} book {j}: code {got} != {want}, "
                                   f"similarity gap {gap:.3g} > {margin:.3g}")
    return out


@contextlib.contextmanager
def s8_plain_trace():
    """Record, while it is open, (``x / sc`` (B, n) f32, ``sc`` (B, 1)) of
    each activation row the plain ``"s8"`` product quantizes
    (``fast_decoder.s8dot``), in order, into the list it yields; a product
    of the same input as the one before (W_1 then W_3) adds nothing, so the
    rows follow ``fast_decoder.s8_trace_layout(cfg, kernel=False)``."""
    real, rows, last = fast_decoder.s8dot, [], []

    def traced(x, w):
        if not last or x is not last[0]:
            rows.append(fast_decoder.s8_scaled(x))
            last[:] = [x]
        return real(x, w)

    fast_decoder.s8dot = traced
    try:
        yield rows
    finally:
        fast_decoder.s8dot = real


S8_SCALE_TOL = 1e-5  # a row's scale against the plain version's, relatively


def s8_decision_margins(cfg, codes, codes_plain, logits, logits_plain, gumbel, temperature,
                        top_p, tol: float, trace_rows, trace_scales, plain_rows,
                        tie: float) -> dict:
    """Hold the ``"s8"`` kernel against its plain version row by quantized row.

    ``trace_rows`` (T, B, width) int8 and ``trace_scales`` (T, B) are the
    kernel's ``fast_decoder.s8_trace``; ``plain_rows`` what
    :func:`s8_plain_trace` recorded of the plain call on the same inputs.
    Per stream the rows are compared in order, each scale within
    S8_SCALE_TOL of the plain one, relatively.  At the first row whose int8
    values differ, every differing element must be one step from the plain
    version's, at an ``x / sc`` within ``tie`` of a .5 boundary (a last-bit
    difference upstream rounds it the other way).  The positions before
    that row's are held by :func:`fast_decision_margins` at ``tol``; from it
    on the stream is excused, since every later row quantizes values the
    moved step has changed.  Rows past a stream's first differing code are
    not compared: the position after it embeds another code.  Returns {"excused": positions excused,
    "witnesses": [(stream, row, (position, layer, kind), elements, widest
    tie distance)], "scale_err": the largest relative scale difference
    compared, "knife_edges", "failures", "max_abs_err", "compared"}."""
    layout = fast_decoder.s8_trace_layout(cfg)
    plain_layout = fast_decoder.s8_trace_layout(cfg, kernel=False)
    if len(plain_rows) != len(plain_layout) or trace_rows.shape[0] < len(layout):
        raise ValueError(f"s8_decision_margins: {len(plain_rows)} plain and "
                         f"{trace_rows.shape[0]} traced rows, want {len(plain_layout)} and "
                         f"{len(layout)}")
    at = {key: i for i, key in enumerate(plain_layout)}
    rows, scales = trace_rows.cpu().long(), trace_scales.cpu().double()
    B, R = codes_plain.shape
    first = [None] * B  # each stream's first differing row
    # rows are compared up to the first differing code: the position after
    # it embeds another code (fast_decision_margins holds that code)
    stop = [R + 1] * B
    for b, r in (codes.cpu() != codes_plain.cpu()).nonzero().tolist():
        stop[b] = min(stop[b], r + 2)
    out = {"excused": 0, "witnesses": [], "scale_err": 0.0, "knife_edges": 0,
           "failures": [], "max_abs_err": 0.0, "compared": 0}
    for t, key in enumerate(layout):
        q, sc = (v.cpu().double() for v in plain_rows[at[key]])
        want = torch.round(q).long()
        got = rows[t, :, :q.shape[1]]
        for b in range(B):
            if first[b] is not None or key[0] >= stop[b]:
                continue
            err = abs(float(scales[t, b]) / float(sc[b, 0]) - 1)
            out["scale_err"] = max(out["scale_err"], err)
            if not err <= S8_SCALE_TOL:
                out["failures"].append(f"stream {b} row {t} {key}: scale {float(scales[t, b])!r}"
                                       f" against {float(sc[b, 0])!r}")
                first[b] = t
                continue
            diff = (got[b] != want[b]).nonzero().flatten()
            if not len(diff):
                continue
            first[b] = t
            dist = float(((q[b, diff] - torch.floor(q[b, diff])) - 0.5).abs().max())
            steps = int((got[b, diff] - want[b, diff]).abs().max())
            out["witnesses"].append((b, t, key, len(diff), dist))
            if steps != 1 or not dist <= tie:
                out["failures"].append(
                    f"stream {b} row {t} {key}: {len(diff)} int8 value(s) differ, by up to "
                    f"{steps} step(s), at tie distances up to {dist:.3g} (limit {tie:.3g})")
    for b in range(B):
        held = R if first[b] is None else max(layout[first[b]][0] - 1, 0)
        out["excused"] += R - held
        if not held:
            continue
        m = fast_decision_margins(codes[b:b + 1, :held], codes_plain[b:b + 1, :held],
                                  logits[b:b + 1, :held], logits_plain[b:b + 1, :held],
                                  gumbel[b:b + 1, :held], _row(temperature, b),
                                  _row(top_p, b), tol)
        out["failures"] += [f"stream {b}" + f[len("stream 0"):] for f in m["failures"]]
        for k in ("knife_edges", "compared"):
            out[k] += m[k]
        out["max_abs_err"] = max(out["max_abs_err"], m["max_abs_err"])
    return out


def _row(x, b: int) -> torch.Tensor:
    """Stream b's entry of a scalar or (B, 1) sampling parameter, as (1, 1)."""
    t = torch.as_tensor(x, dtype=torch.float32).reshape(-1).cpu()
    return t[b if t.numel() > 1 else 0].reshape(1, 1)


# --- the reference's checkpoint layout -------------------------------------------


def _ref_tensor(t: torch.Tensor, dtype) -> torch.Tensor:
    """A state-dict entry: a CPU tensor of its own storage (a slice of a
    stacked weight would otherwise save the whole stack)."""
    return torch.empty(t.shape, dtype=dtype).copy_(t.detach())


def to_reference_lm_state_dict(params, cfg, dtype=torch.bfloat16) -> dict[str, torch.Tensor]:
    """The port's DualAR tree (float, ``(out, in)`` linears) as the
    reference's ``model.pth`` state dict in ``dtype``: per-layer keys,
    linear weights ``(out, in)``."""
    sd = {}

    def put(key, t):
        sd[key] = _ref_tensor(t, dtype)

    for k in ("embeddings", "codebook_embeddings", "norm", "fast_embeddings", "fast_norm",
              "fast_output", "output"):
        if k in params:
            put(f"{k}.weight", params[k])
    if "fast_project_in" in params:
        put("fast_project_in.weight", params["fast_project_in"]["w"])
        put("fast_project_in.bias", params["fast_project_in"]["b"])
    names = {"wqkv": "attention.wqkv.weight", "wo": "attention.wo.weight",
             "w1": "feed_forward.w1.weight", "w3": "feed_forward.w3.weight",
             "w2": "feed_forward.w2.weight", "attention_norm": "attention_norm.weight",
             "ffn_norm": "ffn_norm.weight", "wqkv_b": "attention.wqkv.bias",
             "wo_b": "attention.wo.bias", "q_norm": "attention.q_norm.weight",
             "k_norm": "attention.k_norm.weight"}
    for stack, n in (("layers", cfg.n_layer), ("fast_layers", cfg.n_fast_layer)):
        for k, v in params[stack].items():
            for i in range(n):
                put(f"{stack}.{i}.{names[k]}", v[i])
    return sd


WEIGHT_NORM_NAMINGS = ("parametrizations", "legacy", None)


def to_reference_codec_state_dict(vparams, vcfg, naming: str | None = "parametrizations",
                                  prefix: str = "generator.",
                                  dtype=torch.float32) -> dict[str, torch.Tensor]:
    """The codec tree as the reference's ``codec.pth`` state dict in
    ``dtype``, keys under ``prefix``.  Every conv kernel is split by torch
    weight norm in ``naming`` (``"parametrizations"``:
    ``parametrizations.weight.original0/1``, ``"legacy"``:
    ``weight_g/weight_v``; None keeps a plain ``weight``): ``v`` the
    kernel, ``g`` its norm over every axis but the first (float64, then
    ``dtype``), so the converter's fold gives the kernel back to within an
    f32 step.  Linear weights are transposed to ``(out, in)``."""
    if naming not in WEIGHT_NORM_NAMINGS:
        raise ValueError(f"naming={naming!r}: expected one of {WEIGHT_NORM_NAMINGS}")
    sd = {}

    def put(key, t):
        sd[prefix + key] = _ref_tensor(t, dtype)

    def conv(key, p):
        w = p["w"]
        if naming is None:
            put(f"{key}.weight", w)
        else:
            w64 = w.detach().cpu().double()
            g = torch.sqrt((w64 ** 2).sum(dim=tuple(range(1, w.ndim)), keepdim=True))
            gk, vk = (("parametrizations.weight.original0", "parametrizations.weight.original1")
                      if naming == "parametrizations" else ("weight_g", "weight_v"))
            put(f"{key}.{gk}", g)
            put(f"{key}.{vk}", w)
        put(f"{key}.bias", p["b"])

    def linear(key, p):
        put(f"{key}.weight", p["w"].transpose(0, 1))
        put(f"{key}.bias", p["b"])

    def unit(key, p):
        put(f"{key}.block.0.alpha", p["snake1"])
        conv(f"{key}.block.1.conv", p["conv1"])
        put(f"{key}.block.2.alpha", p["snake2"])
        conv(f"{key}.block.3.conv", p["conv2"])

    def wlt(key, p):
        lay = p["layers"]
        names = {"wqkv": "attention.wqkv.weight", "wo": "attention.wo.weight",
                 "w1": "feed_forward.w1.weight", "w3": "feed_forward.w3.weight",
                 "w2": "feed_forward.w2.weight"}
        plain = {"attention_norm": "attention_norm.weight", "ffn_norm": "ffn_norm.weight",
                 "attn_scale": "attention_layer_scale.gamma",
                 "ffn_scale": "ffn_layer_scale.gamma",
                 "rel_pos_embeddings": "attention.rel_pos_embeddings"}
        for i in range(lay["wqkv"].shape[0]):
            for k, name in names.items():
                put(f"{key}.layers.{i}.{name}", lay[k][i].transpose(0, 1))
            for k, name in plain.items():
                if k in lay:
                    put(f"{key}.layers.{i}.{name}", lay[k][i])
        put(f"{key}.norm.weight", p["norm"])
        for k in ("input_proj", "output_proj"):
            if k in p:
                linear(f"{key}.{k}", p[k])

    def convnext(key, p):
        conv(f"{key}.dwconv.conv", p["dwconv"])
        put(f"{key}.norm.weight", p["norm_w"])
        put(f"{key}.norm.bias", p["norm_b"])
        linear(f"{key}.pwconv1", p["pw1"])
        linear(f"{key}.pwconv2", p["pw2"])
        put(f"{key}.gamma", p["gamma"])

    def vq(key, p):
        conv(f"{key}.in_proj", p["in_proj"])
        conv(f"{key}.out_proj", p["out_proj"])
        put(f"{key}.codebook.weight", p["codebook"])

    enc = vparams["encoder"]
    conv("encoder.block.0.conv", enc["stem"])
    for b, block in enumerate(enc["blocks"]):
        base = f"encoder.block.{b + 1}.block"
        for u, p in enumerate(block["units"]):
            unit(f"{base}.{u}", p)
        put(f"{base}.3.alpha", block["snake"])
        conv(f"{base}.4.conv", block["down"])
        if "wlt" in block:
            wlt(f"{base}.5", block["wlt"])
    n = len(enc["blocks"])
    put(f"encoder.block.{n + 1}.alpha", enc["final_snake"])
    conv(f"encoder.block.{n + 2}.conv", enc["final_conv"])

    q = vparams["quantizer"]
    for i, p in enumerate(q["downsample"]):
        conv(f"quantizer.downsample.{i}.0.conv", p["conv"])
        convnext(f"quantizer.downsample.{i}.1", p["convnext"])
    wlt("quantizer.pre_module", q["pre"])
    wlt("quantizer.post_module", q["post"])
    vq("quantizer.semantic_quantizer.quantizers.0", q["semantic"])
    for i, p in enumerate(q["residual"]):
        vq(f"quantizer.quantizer.quantizers.{i}", p)
    for i, p in enumerate(q["upsample"]):
        conv(f"quantizer.upsample.{i}.0.conv", p["tconv"])
        convnext(f"quantizer.upsample.{i}.1", p["convnext"])

    dec = vparams["decoder"]
    conv("decoder.model.0.conv", dec["stem"])
    for b, block in enumerate(dec["blocks"]):
        base = f"decoder.model.{b + 1}.block"
        put(f"{base}.0.alpha", block["snake"])
        conv(f"{base}.1.conv", block["up"])
        for u, p in enumerate(block["units"]):
            unit(f"{base}.{u + 2}", p)
    n = len(dec["blocks"])
    put(f"decoder.model.{n + 1}.alpha", dec["final_snake"])
    conv(f"decoder.model.{n + 2}.conv", dec["final_conv"])
    return sd


def write_reference_dir(out, bundle, naming: str | None = "parametrizations",
                        lm_dtype=torch.bfloat16) -> Path:
    """Write ``bundle`` (``make_tiny_bundle`` / ``make_s1_mini_bundle``'s
    tuple) as a reference checkpoint directory: ``config.json``,
    ``tokenizer.tiktoken``, ``special_tokens.json``, ``model.pth`` in
    ``lm_dtype`` and ``codec.pth`` in float32 (``generator.`` keys, weight
    norm in ``naming``), with ``vocoder_config.json`` only when the codec
    is not the default one (the reference's directory has none).  Returns
    the directory."""
    cfg, params, tokenizer, vcfg, vparams = bundle
    out = Path(out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "config.json").write_text(json.dumps(dataclasses.asdict(cfg), indent=2))
    ranks = sorted(tokenizer._ranks.items(), key=lambda kv: kv[1])
    (out / "tokenizer.tiktoken").write_text(
        "".join(f"{base64.b64encode(t).decode()} {r}\n" for t, r in ranks))
    (out / "special_tokens.json").write_text(json.dumps(list(tokenizer.all_special_tokens_with_ids)))
    torch.save(to_reference_lm_state_dict(params, cfg, dtype=lm_dtype), out / "model.pth")
    if vparams is not None:
        torch.save(to_reference_codec_state_dict(vparams, vcfg, naming=naming), out / "codec.pth")
        if vcfg != VocoderConfig():
            vcfg.to_json(out / "vocoder_config.json")
    return out
