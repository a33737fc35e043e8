"""Attribute the batched slow-stack step on the plain route: the matmul chain
alone, the attention alone, the cache write alone, and the whole step.

The port's counterpart of ``scripts/profile_slow_parts.py``.  Rows, each a
loop of 20 frames:

- "matmul chain only (loop over layers)": per layer the qkv, output and
  SwiGLU products through ``ops/slow_stack.qdot`` (the int8 GEMV numerics
  of the kernel's plain version), no attention, no cache;
- "attention only (R-slice, no scatter)": per layer the plain route's
  ``ops/attention.gqa_attention_two_part`` (its fixed 256-key blocks) over
  the first R cache rows, no products, no write.  The JAX script adds the
  (B, head_dim) attention output to its (B, dim) carry, which fails to
  broadcast; the port carries a (B, head_dim) vector instead;
- "cache scatter only (advanced idx)": each stream's K/V row written at its
  position with one indexed write, as the engine does;
- "cache scatter only (B x row copy)": the same write as B row copies, the
  counterpart of the JAX script's B ``dynamic_update_slice``;
- "full slow_forward (plain route)": ``dual_ar.slow_forward`` against the
  cache.

B = 8, R = ``min(max_seq_len, 512)``, position 64, int8 weights (the tiny
config's quantized too, so that ``qdot`` applies).  On the card each loop is
captured once in a CUDA graph and replayed, timed between CUDA events; with
``--device cpu`` the eager loops run on the host's clock.

Usage: python -m fish_tts_tpu_torch.scripts.profile_slow_parts [-b 8] [-n 5] [--tiny]
       [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.models import dual_ar
from fish_tts_tpu_torch.models.dual_ar import TokenIds
from fish_tts_tpu_torch.ops import slow_stack
from fish_tts_tpu_torch.ops.attention import NEG_INF, gqa_attention_two_part
from fish_tts_tpu_torch.scripts._timing import (
    Loop,
    device_line,
    free,
    lm,
    record,
    resolve_device,
    time_loop,
)

FRAMES = 20


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per part and return them as records
    (``_timing.record``: label, value in ms/frame, device, clock, how)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=8)
    ap.add_argument("-n", type=int, default=5)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, params, rope = lm(args.tiny, dev, int8=True)
    ids = TokenIds(400, 447, 5) if args.tiny else TokenIds(151672, 155767, 151661)
    dtype = params["norm"].dtype
    B = args.b
    R = min(cfg.max_seq_len, 512)
    L, Dh = cfg.n_layer, cfg.head_dim
    print(f"# device={device_line(dev)} B={B} R={R}", flush=True)
    records = []

    def report(label: str, body):
        loop = Loop(body, FRAMES, dev)
        per, note = time_loop(loop, dev, args.n)
        records.append(record(label, per * 1e3, "ms/frame", dev, loop.how))
        print(f"{label:40s}: {per*1e3:7.3f} ms/frame{note}", flush=True)
        del loop
        free(dev)

    layers = [slow_stack.layer(params["layers"], i) for i in range(L)]
    kv = dual_ar.init_kv_cache(cfg, B, cfg.max_seq_len, dtype, device=dev)
    pos = torch.full((B,), 64, dtype=torch.int32, device=dev)
    zero = torch.zeros((), device=dev)
    block_bias = torch.zeros((1, 1, 1, 1), device=dev)

    # 1. matmuls only: per-layer qkv/o/ffn chain, no attention, no cache
    h = torch.zeros((B, cfg.dim), dtype=torch.float32, device=dev)

    def matmuls(_):
        x = h
        for lp in layers:
            q = slow_stack.qdot(x, lp["wqkv"])
            x = x + slow_stack.qdot(q[:, :cfg.dim], lp["wo"])
            f = slow_stack.qdot(x, lp["w1"])
            g = slow_stack.qdot(x, lp["w3"])
            x = x + slow_stack.qdot(f * g, lp["w2"])
        h.copy_(x)

    report("matmul chain only (loop over layers)", matmuls)

    # 2. attention only: per-layer two-part attention against the R-slice
    k_read, v_read = kv["k"][:, :, :, :R], kv["v"][:, :, :, :R]
    q0 = torch.zeros((B, cfg.n_head, 1, Dh), dtype=dtype, device=dev)
    k0 = torch.zeros((B, cfg.n_local_heads, 1, Dh), dtype=dtype, device=dev)
    cache_bias = torch.where(torch.arange(R, device=dev)[None, None, None, :]
                             < pos[:, None, None, None], zero, NEG_INF)
    c = torch.zeros((B, Dh), dtype=dtype, device=dev)

    def attention(_):
        x = c
        for layer in range(L):
            o = gqa_attention_two_part(q0 + x[:, None, None, :], k_read[layer], v_read[layer],
                                       cache_bias, k0, k0, block_bias)
            x = x + o[:, 0, 0]
        c.copy_(x)

    report("attention only (R-slice, no scatter)", attention)

    # 3. scatter only: the per-frame KV cache row write, one indexed write
    rows = torch.zeros((L, B, cfg.n_local_heads, Dh), dtype=dtype, device=dev)
    b_idx = torch.arange(B, device=dev)

    def scatter(i):
        if i == 0:
            pos.fill_(64)
        p_idx = pos.long()
        for cache in (kv["k"], kv["v"]):
            cache[:, b_idx, :, p_idx] = rows.transpose(0, 1)
        pos.add_(1)

    report("cache scatter only (advanced idx)", scatter)

    # 4. the same write as B row copies, each at its stream's position
    def scatter_rows(i):
        if i == 0:
            pos.fill_(64)
        for cache in (kv["k"], kv["v"]):
            for b in range(B):
                cache[:, b].index_copy_(2, pos[b:b + 1].long(), rows[:, b, :, None])
        pos.add_(1)

    report("cache scatter only (B x row copy)", scatter_rows)

    # 5. the full slow_forward for reference
    inp = torch.zeros((B, 1 + cfg.num_codebooks, 1), dtype=torch.int32, device=dev)
    k_pos = torch.arange(R, device=dev)

    def full(i):
        if i == 0:
            pos.fill_(64)
        bias = torch.where(k_pos[None, None, None, :] < pos[:, None, None, None], zero, NEG_INF)
        dual_ar.slow_forward(params, cfg, ids, rope, inp, pos[:, None], kv, bias, block_bias,
                             read_len=R)
        pos.add_(1)

    report("full slow_forward (plain route)", full)
    return records


if __name__ == "__main__":
    main()
