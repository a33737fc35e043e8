"""Component-level profiling of the batched (B > 1) decode step.

The port's counterpart of ``scripts/profile_batch.py``: it attributes the
per-frame budget at a batch size.  Rows on the plain route
(``fast_kernel=False``, PyTorch and cuBLAS):

- "decode chunk (plain route)": the production chunk;
- "slow stack alone (plain route)": ``dual_ar.slow_forward`` against the
  cache, no head, sampling or fast loop;
- "LM head alone (plain route)": ``dual_ar.lm_logits``;
- "fast codebook loop alone (plain route)": a fresh fast cache, position 0,
  then one ``fast_step`` and an argmax per residual book;
- "slow sampling alone (top_p thresh)": ``engine/sampling.sample`` with
  ``top_k=-1`` over the whole vocabulary.

With ``--kernels`` (int8 weights, the default off ``--tiny``, and with
``--kernels`` at ``--tiny`` too, so that its kernel rows run): "decode
chunk (kernels)", "slow kernel + head + scatter" (``slow_stack_step`` and
each stream's K/V row written at its position), "fast kernel (codebook
loop)" (``fast_decode_frame``) and "sampler kernel (fused top-p)"
(``sample_slow``), each where its gate takes the batch.

B = 8 at position 64, a kv read of ``min(max_seq_len, 512)`` rows, 20 frames
per loop, ``-n`` timed loops after a warm one.  On the card a chunk is a
``DecodeGraph`` replayed per frame, and every component is its loop of 20
iterations captured once in a CUDA graph and replayed, timed between CUDA
events; with ``--device cpu`` the eager loops run on the host's clock.

Usage: python -m fish_tts_tpu_torch.scripts.profile_batch [-b 8] [-n N] [--kernels]
       [--tiny] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import torch

from fish_tts_tpu_torch.engine import decode
from fish_tts_tpu_torch.engine.sampling import sample
from fish_tts_tpu_torch.models import dual_ar
from fish_tts_tpu_torch.models.dual_ar import TokenIds
from fish_tts_tpu_torch.ops import fast_decoder, sampler_kernel, slow_stack
from fish_tts_tpu_torch.ops.attention import NEG_INF
from fish_tts_tpu_torch.scripts._timing import (
    Chunks,
    Loop,
    device_line,
    free,
    lm,
    record,
    reset_state,
    resolve_device,
    time_loop,
)
from fish_tts_tpu_torch.utils.quantize import qgather

FRAMES = 20
SAMPLING = (0.7, 0.8, 1.1)  # temperature, top_p, repetition penalty
WINDOW = 16


def main(argv: list[str] | None = None) -> list[dict]:
    """Print one line per component and return them as records
    (``_timing.record``: label, value in ms/frame, device, clock, how)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("-b", type=int, default=8, help="batch size")
    ap.add_argument("-n", type=int, default=5, help="timing repetitions")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--kernels", action="store_true",
                    help="also time the kernels' batched path")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    tiny = args.tiny
    int8 = not tiny or args.kernels  # the kernels take int8 weights only
    cfg, params, rope = lm(tiny, dev, int8)
    ids = TokenIds(400, 447, 5) if tiny else TokenIds(151672, 155767, 151661)
    B = args.b
    kv_b = min(cfg.max_seq_len, 512)
    dt_ = params["norm"].dtype
    K = cfg.num_codebooks
    print(f"# device={device_line(dev)} B={B} int8={int8}", flush=True)
    records = []
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    cols = [torch.full((B, 1), v, device=dev) for v in SAMPLING]

    def report(label: str, loop):
        per, note = time_loop(loop, dev, args.n)
        records.append(record(label, per * 1e3, "ms/frame", dev, loop.how))
        print(f"{label:36s}: {per*1e3:7.3f} ms/frame -> {B/per:7.1f} tok/s aggregate{note}",
              flush=True)
        free(dev)

    # ---- full decode chunk (the production batched path) -----------------
    def chunk_row(label: str, fast_kernel: bool):
        state = reset_state(decode.init_state(params, cfg, batch=B), 64, 0, SAMPLING, 0)
        chunks = Chunks(params, cfg, ids, rope, state, frames=FRAMES, kv_bucket=kv_b,
                        skip_done=True, top_k=-1, fast_kernel=fast_kernel)
        chunks()  # warm
        report(label, chunks)

    chunk_row("decode chunk (plain route)", False)
    if args.kernels:
        chunk_row("decode chunk (kernels)", True)

    # ---- slow stack alone (no head, no sampling, no fast loop) -----------
    kv = dual_ar.init_kv_cache(cfg, B, cfg.max_seq_len, dt_, device=dev)
    pos = torch.full((B,), 64, dtype=torch.int32, device=dev)
    inp = torch.zeros((B, 1 + K, 1), dtype=torch.int32, device=dev)
    k_pos = torch.arange(kv_b, device=dev)
    zero = torch.zeros((), device=dev)
    block_bias = torch.zeros((1, 1, 1, 1), device=dev)

    def slow_body(i: int):
        if i == 0:
            pos.fill_(64)
        cache_bias = torch.where(k_pos[None, None, None, :] < pos[:, None, None, None],
                                 zero, NEG_INF)
        dual_ar.slow_forward(params, cfg, ids, rope, inp, pos[:, None], kv, cache_bias,
                             block_bias, read_len=kv_b)
        pos.add_(1)

    report("slow stack alone (plain route)", Loop(slow_body, FRAMES, dev))

    # ---- LM head alone ---------------------------------------------------
    hs = torch.zeros((FRAMES, B, 1, cfg.dim), dtype=dt_, device=dev)
    report("LM head alone (plain route)",
           Loop(lambda i: dual_ar.lm_logits(params, cfg, hs[i]), FRAMES, dev))

    # ---- fast codebook loop alone ----------------------------------------
    h_fast = torch.zeros((FRAMES, B, 1, cfg.fast_dim), dtype=dt_, device=dev)
    Vr = cfg.residual_codebook_size

    def fast_body(i: int):
        cache = dual_ar.new_fast_cache(params, cfg, B)
        dual_ar.fast_step(params, cfg, rope, h_fast[i], 0, cache)
        emb = torch.zeros((B, 1, cfg.fast_dim), dtype=dt_, device=dev)
        for cb in range(1, K):
            logits = dual_ar.fast_step(params, cfg, rope, emb, cb, cache)
            code = torch.argmax(logits[:, -1, :Vr], dim=-1)
            emb = qgather(params["fast_embeddings"], code, dt_)[:, None]

    report("fast codebook loop alone (plain route)", Loop(fast_body, FRAMES, dev))

    # ---- slow-token sampling alone ---------------------------------------
    logits = torch.randn((B, cfg.vocab_size), generator=gen, device=dev) * 4.0
    gumbel = decode.gumbel_from_uniform(
        torch.rand((FRAMES, B, cfg.vocab_size), generator=gen, device=dev))
    report("slow sampling alone (top_p thresh)",
           Loop(lambda i: sample(gumbel[i], logits, *cols, prev_idx=None, top_k=-1),
                FRAMES, dev))

    if not args.kernels:
        return records

    # ---- kernel-path components -------------------------------------------
    if slow_stack.supports(cfg, params, B):
        x = torch.zeros((B, cfg.dim), dtype=torch.float32, device=dev)
        b_idx = torch.arange(B, device=dev)

        def slow_kernel_body(i: int):
            if i == 0:
                pos.fill_(64)
            _, new_k, new_v, _ = slow_stack.slow_stack_step(
                params, cfg, rope["slow"], x, kv, pos, read_len=kv_b)
            p_idx = pos.long()
            for cache, new in ((kv["k"], new_k), (kv["v"], new_v)):
                cache[:, b_idx, :, p_idx] = new[:, :, :, 0].transpose(0, 1).to(cache.dtype)
            pos.add_(1)

        report("slow kernel + head + scatter", Loop(slow_kernel_body, FRAMES, dev))

    if fast_decoder.supports(cfg, params, B, WINDOW):
        h = torch.zeros((B, cfg.fast_dim), dtype=torch.float32, device=dev)
        a0 = torch.zeros((B,), dtype=torch.int32, device=dev)
        prev_rows = torch.zeros((B, K - 1, WINDOW), dtype=torch.int32, device=dev)
        g_fast = decode.gumbel_from_uniform(
            torch.rand((FRAMES, B, K - 1, Vr), generator=gen, device=dev))
        report("fast kernel (codebook loop)",
               Loop(lambda i: fast_decoder.fast_decode_frame(
                   params, cfg, rope["fast"], h, a0, prev_rows, g_fast[i], *cols,
                   window=WINDOW), FRAMES, dev))

    if sampler_kernel.supports(B, -1):
        pc = torch.zeros((B, 1 + K), dtype=torch.int32, device=dev)
        report("sampler kernel (fused top-p)",
               Loop(lambda i: sampler_kernel.sample_slow(logits, pc, gumbel[i], *cols),
                    FRAMES, dev))
    return records


if __name__ == "__main__":
    main()
