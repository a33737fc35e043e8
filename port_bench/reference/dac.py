"""Plain DAC codec decode in float32: codes -> waveform.

The published S1-mini codec's decode side: each book's code looked up in
its codebook and projected (a 1x1 conv), the books summed; a window-128
causal transformer (RMSNorm, rotary attention, SwiGLU, layer scales); two
x2 upsampling stages (causal transposed conv + ConvNeXt); then the decoder:
a causal conv7 stem, four stages of Snake + causal transposed conv + three
dilated residual units, Snake, conv7 and tanh.  Causal convs pad on the
left; a transposed conv drops ``kernel - stride`` samples on the right.

``mode`` ``"bf16"`` computes on the weights as they are; ``"fp8"`` rounds
every weight per output channel and every conv's and product's input per
time step to float8 e4m3 first.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from port_bench.reference.dual_ar import f32_only, qdq, rope

DILATIONS = (1, 3, 9)


class DAC:
    """The decode side of the codec of ``cfg`` (a configuration's
    ``codec`` sizes) on ``params``."""

    def __init__(self, params: dict, cfg: dict, mode: str):
        f32_only()
        self.cfg, self.fp8 = cfg, mode == "fp8"

        def cast(t):
            if isinstance(t, dict):
                return {k: cast(v) for k, v in t.items()}
            if isinstance(t, list):
                return [cast(v) for v in t]
            if self.fp8 and t.ndim >= 2:
                return qdq(t.reshape(t.shape[0], -1), "fp8").reshape(t.shape)
            return t.float()

        self.q, self.d = cast(params["quantizer"]), cast(params["decoder"])

    def _act(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        if not self.fp8:
            return x
        return qdq(x.movedim(axis, -1), "fp8").movedim(-1, axis)

    def conv(self, x, p, dilation=1, groups=1):
        """Causal conv, stride 1: (1, C, T) -> (1, O, T)."""
        k = p["w"].shape[-1]
        x = F.pad(self._act(x, 1), ((k - 1) * dilation, 0))
        return F.conv1d(x, p["w"], p["b"], dilation=dilation, groups=groups)

    def tconv(self, x, p, stride):
        k = p["w"].shape[-1]
        y = F.conv_transpose1d(self._act(x, 1), p["w"], p["b"], stride=stride)
        return y[..., :y.shape[-1] - (k - stride)] if k > stride else y

    def linear(self, x, p):
        return self._act(x, -1) @ p["w"] + p["b"]

    @staticmethod
    def snake(x, alpha):
        return x + torch.sin(alpha * x) ** 2 / (alpha + 1e-9)

    def wlt(self, p, x):
        """The window-limited transformer on (1, C, T)."""
        t = self.cfg["quantizer_transformer"]
        H, Dh, eps, W = t["n_head"], t["head_dim"], t["norm_eps"], self.cfg["quantizer_window"]
        x = x.transpose(1, 2)[0]
        T = x.shape[0]
        cos, sin = rope(T, Dh, t["rope_base"], x.device)
        i = torch.arange(T, device=x.device)
        d = i[:, None] - i[None]
        mask = torch.where((d >= 0) & (d < W), 0.0, float("-inf"))
        lay = p["layers"]

        def rms(v, g):
            return v * torch.rsqrt((v * v).mean(dim=-1, keepdim=True) + eps) * g

        def rot(v):
            vr, vi = v[..., 0::2], v[..., 1::2]
            c, s = cos[:, None], sin[:, None]
            return torch.stack([vr * c - vi * s, vi * c + vr * s], -1).flatten(-2)

        for n in range(lay["wqkv"].shape[0]):
            h = rms(x, lay["attention_norm"][n])
            qkv = self._act(h, -1) @ lay["wqkv"][n]
            q, k, v = (qkv[:, j * H * Dh:(j + 1) * H * Dh].reshape(T, H, Dh) for j in range(3))
            q, k = rot(q), rot(k)
            s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(Dh) + mask
            o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v).reshape(T, H * Dh)
            x = x + (self._act(o, -1) @ lay["wo"][n]) * lay["attn_scale"][n]
            f = rms(x, lay["ffn_norm"][n])
            g = self._act(f, -1) @ lay["w1"][n]
            u = self._act(g * torch.sigmoid(g) * (self._act(f, -1) @ lay["w3"][n]), -1)
            x = x + (u @ lay["w2"][n]) * lay["ffn_scale"][n]
        x = rms(x, p["norm"])
        return x.T[None]

    def convnext(self, p, x):
        y = self.conv(x, p["dwconv"], groups=x.shape[1]).transpose(1, 2)
        mu = y.mean(dim=-1, keepdim=True)
        var = ((y - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (y - mu) * torch.rsqrt(var + 1e-6) * p["norm_w"] + p["norm_b"]
        y = F.gelu(self.linear(y, p["pw1"]), approximate="none")
        y = self.linear(y, p["pw2"]) * p["gamma"]
        return x + y.transpose(1, 2)

    @torch.no_grad()
    def __call__(self, codes: torch.Tensor) -> torch.Tensor:
        """codes (K, N) -> waveform (N * frame_length,) in [-1, 1]."""
        cfg, q, d = self.cfg, self.q, self.d
        codes = codes.long()
        books = [q["semantic"], *q["residual"]]
        sizes = [cfg["semantic_codebook_size"]] + [cfg["residual_codebook_size"]] * (
            len(books) - 1)
        z = 0
        for book, c, n in zip(books, codes, sizes):
            e = book["codebook"][c.clamp(0, n - 1)]  # (N, dim)
            z = z + (e @ book["out_proj"]["w"][:, :, 0].T + book["out_proj"]["b"]).T[None]
        z = self.wlt(q["post"], z)
        for stage, f in zip(q["upsample"], reversed(cfg["downsample_factor"])):
            z = self.convnext(stage["convnext"], self.tconv(z, stage["tconv"], f))
        x = self.conv(z, d["stem"])
        for block, stride in zip(d["blocks"], cfg["decoder_rates"]):
            x = self.tconv(self.snake(x, block["snake"]), block["up"], stride)
            for unit, dil in zip(block["units"], DILATIONS):
                y = self.conv(self.snake(x, unit["snake1"]), unit["conv1"], dilation=dil)
                x = x + self.conv(self.snake(y, unit["snake2"]), unit["conv2"])
        x = self.conv(self.snake(x, d["final_snake"]), d["final_conv"])
        return torch.tanh(x)[0, 0]
