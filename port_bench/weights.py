"""Seeded weights at a configuration's sizes, made on the device.

Every random leaf is a slice of one ``torch.randn`` buffer drawn by a
``torch.Generator`` on the device, in the dtype the model is served in, and
scaled (and shifted, where its spec gives a mean) in place; norms and layer
scales are constants.  The same seed gives the same weights on the same
device.  The trees are the parameter layout ``FishTTS`` takes (linear LM
weights ``(out, in)``; the codec's convs ``(O, I/groups, K)``, transposed
convs ``(I, O, K)``, linear ``(in, out)``).

The tied embedding's semantic rows are drawn with ``semantic_std``, wider
than the other rows' ``std``: then the head, as a trained S1-mini does
while it speaks, puts nearly all its mass on semantic tokens, and a frame's
token is ``semantic_begin`` plus its first code.  ``<|im_end|>`` keeps the
narrow rows, so no request ends before its ``max_new_tokens``.  Only the
codec's decode side is made: no cell encodes audio.
"""

from __future__ import annotations

import math

import torch

# (path, shape, init): init is ("normal", std), ("normal", std, mean) or
# ("const", value)
Spec = tuple[tuple, tuple, tuple]


def _stack_specs(prefix: str, n: int, dim: int, heads: int, kv_heads: int, head_dim: int,
                 ffn: int, std: float) -> list[Spec]:
    qkv = (heads + 2 * kv_heads) * head_dim
    return [
        ((prefix, "wqkv"), (n, qkv, dim), ("normal", std)),
        ((prefix, "wo"), (n, dim, heads * head_dim), ("normal", std)),
        ((prefix, "w1"), (n, ffn, dim), ("normal", std)),
        ((prefix, "w3"), (n, ffn, dim), ("normal", std)),
        ((prefix, "w2"), (n, dim, ffn), ("normal", std)),
        ((prefix, "attention_norm"), (n, dim), ("const", 1.0)),
        ((prefix, "ffn_norm"), (n, dim), ("const", 1.0)),
    ]


def lm_specs(cfg: dict) -> list[Spec]:
    std = cfg["init_std"]
    D, Df, cb = cfg["dim"], cfg["fast_dim"], cfg["codebook_size"]
    return [
        (("embeddings",), (cfg["vocab_size"], D), ("normal", std)),
        (("codebook_embeddings",), (cb * cfg["num_codebooks"], D), ("normal", std)),
        *_stack_specs("layers", cfg["n_layer"], D, cfg["n_head"], cfg["n_local_heads"],
                      cfg["head_dim"], cfg["intermediate_size"], std),
        (("norm",), (D,), ("const", 1.0)),
        (("fast_embeddings",), (cb, Df), ("normal", std)),
        *_stack_specs("fast_layers", cfg["n_fast_layer"], Df, cfg["fast_n_head"],
                      cfg["fast_n_local_heads"], cfg["fast_head_dim"],
                      cfg["fast_intermediate_size"], std),
        (("fast_norm",), (Df,), ("const", 1.0)),
        (("fast_output",), (cb, Df), ("normal", std)),
    ]


def _conv(path, c_out, c_in, k, std):
    return [((*path, "w"), (c_out, c_in, k), ("normal", std)),
            ((*path, "b"), (c_out,), ("const", 0.0))]


def _linear(path, d_in, d_out, std):
    return [((*path, "w"), (d_in, d_out), ("normal", std)),
            ((*path, "b"), (d_out,), ("const", 0.0))]


def codec_specs(v: dict) -> list[Spec]:
    std = v["init_std"]
    t = v["quantizer_transformer"]
    qd, L, D, I = v["quantizer_input_dim"], t["n_layer"], t["dim"], t["intermediate_size"]
    qkv = 3 * t["n_head"] * t["head_dim"]
    post = ("quantizer", "post")
    specs = [
        ((*post, "layers", "wqkv"), (L, D, qkv), ("normal", std)),
        ((*post, "layers", "wo"), (L, t["n_head"] * t["head_dim"], D), ("normal", std)),
        ((*post, "layers", "w1"), (L, D, I), ("normal", std)),
        ((*post, "layers", "w3"), (L, D, I), ("normal", std)),
        ((*post, "layers", "w2"), (L, I, D), ("normal", std)),
        ((*post, "layers", "attention_norm"), (L, D), ("const", 1.0)),
        ((*post, "layers", "ffn_norm"), (L, D), ("const", 1.0)),
        ((*post, "layers", "attn_scale"), (L, D), ("const", 1e-2)),
        ((*post, "layers", "ffn_scale"), (L, D), ("const", 1e-2)),
        ((*post, "norm"), (D,), ("const", 1.0)),
    ]
    books = [("semantic", v["semantic_codebook_size"])] + [
        (("residual", i), v["residual_codebook_size"]) for i in range(v["n_residual_codebooks"])]
    for name, size in books:
        path = ("quantizer", *(name if isinstance(name, tuple) else (name,)))
        specs += _conv((*path, "out_proj"), qd, v["codebook_dim"], 1, std)
        specs.append(((*path, "codebook"), (size, v["codebook_dim"]), ("normal", 1.0)))
    for i, f in enumerate(reversed(v["downsample_factor"])):
        up = ("quantizer", "upsample", i)
        specs += [((*up, "tconv", "w"), (qd, qd, f), ("normal", std)),
                  ((*up, "tconv", "b"), (qd,), ("const", 0.0)),
                  *_conv((*up, "convnext", "dwconv"), qd, 1, 7, std),
                  ((*up, "convnext", "norm_w"), (qd,), ("const", 1.0)),
                  ((*up, "convnext", "norm_b"), (qd,), ("const", 0.0)),
                  *_linear((*up, "convnext", "pw1"), qd, 4 * qd, std),
                  *_linear((*up, "convnext", "pw2"), 4 * qd, qd, std),
                  ((*up, "convnext", "gamma"), (qd,), ("const", 1e-6))]
    ch, latent = v["decoder_dim"], v["latent_dim"]
    specs += _conv(("decoder", "stem"), ch, latent, 7, std)
    out = ch
    for i, stride in enumerate(v["decoder_rates"]):
        d_in, out = ch // 2 ** i, ch // 2 ** (i + 1)
        blk = ("decoder", "blocks", i)
        specs += [((*blk, "snake"), (1, d_in, 1), ("const", 1.0)),
                  ((*blk, "up", "w"), (d_in, out, 2 * stride), ("normal", std)),
                  ((*blk, "up", "b"), (out,), ("const", 0.0))]
        for u in range(3):
            unit = (*blk, "units", u)
            specs += [((*unit, "snake1"), (1, out, 1), ("const", 1.0)),
                      *_conv((*unit, "conv1"), out, out, 7, std),
                      ((*unit, "snake2"), (1, out, 1), ("const", 1.0)),
                      *_conv((*unit, "conv2"), out, out, 1, std)]
    specs += [(("decoder", "final_snake"), (1, out, 1), ("const", 1.0)),
              *_conv(("decoder", "final_conv"), 1, out, 7, std)]
    return specs


def _lists(node):
    """Dicts keyed 0..n-1 (the layer and stage lists) as lists."""
    if not isinstance(node, dict):
        return node
    out = {k: _lists(v) for k, v in node.items()}
    if out and all(isinstance(k, int) for k in out):
        return [out[i] for i in range(len(out))]
    return out


@torch.no_grad()
def make(specs: list[Spec], seed: int, device, dtype) -> dict:
    """The tree of ``specs`` from ``seed``: all normal leaves from one draw."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    normal = [s for s in specs if s[2][0] == "normal"]
    total = sum(math.prod(s[1]) for s in normal)
    buf = torch.randn((total,), generator=gen, device=device, dtype=dtype)
    tree: dict = {}
    off = 0
    for path, shape, init in specs:
        if init[0] == "normal":
            n = math.prod(shape)
            leaf = buf[off:off + n].view(shape).mul_(init[1])
            if len(init) > 2:
                leaf.add_(init[2])
            off += n
        else:
            leaf = torch.full(shape, init[1], device=device, dtype=dtype)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return _lists(tree)


def lm(cfg: dict, seed: int, semantic_begin: int, device, dtype=torch.bfloat16,
       specs=lm_specs) -> dict:
    """The LM's weights as ``specs(cfg)`` lists them (a reference module's
    own ``lm_specs``, where it has one); the semantic rows of the tied
    table widened."""
    params = make(specs(cfg), 2 * seed, device, dtype)
    rows = params["embeddings"][semantic_begin:semantic_begin + cfg["codebook_size"]]
    rows.mul_(cfg["semantic_std"] / cfg["init_std"])
    return params


def codec(vcfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    return make(codec_specs(vcfg), 2 * seed + 1, device, dtype)
