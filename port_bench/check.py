"""Whether what the timed path served is right: the reference judges it.

Once the window has closed and the program is freed, two samples of the
requests it finished (each the longest, then others drawn from the seed,
until some hundreds of frames) go to the plain float32 reference, on
weights made again from the seed: one of the greedy requests and one of
those that sample.

- ``slow_gap`` / ``fast_gap`` (greedy): teacher-forced over the request's
  prompt and its served frames, the widest gap by which a served token's
  logit lies below the reference's best, for the slow tokens (the slow
  stack, its tied head and the sampler) and for the residual codes (the
  fast stack and its sampling).  A served frame's token is
  ``semantic_begin`` plus its first code (the weights make the head speak
  semantic tokens, ``weights.py``);
- ``sampled_slow_gap`` / ``sampled_fast_gap`` (sampled): the same, against
  the reference's own draw by the sampler's rules from the request's noise
  (``reference/sampling.py``): repetition penalty, nucleus, temperature;
- ``mean_gap``: the mean of those gaps over every token of both samples,
  which the one near-tie that decides a widest gap does not swing: a lower
  precision moves it more than the widest;
- ``pcm_err`` (greedy): the largest difference, in full-scale units,
  between the PCM served for the request and the reference codec's decode
  of its served codes;
- ``frames_missing`` / ``pcm_samples_off``: frames short of the request's
  ``max_new_tokens``, and PCM samples off ``frames x frame_length``
  (exact: limit 0; PCM of the greedy requests).

The reference LM is the module ``reference/<stem>.py`` that the
configuration names under ``"reference"`` (``dual_ar``, the stand-ins',
without the key): its ``DualAR``, and its ``lm_specs`` where it has one
for the weights.  The module states what it computes (``SIZES``,
``FLAGS``); :func:`refuse` stops a run whose configuration sets anything
else, before the program is built.  The sampling rules, the prompt and
the codec's reference are shared.

A control puts the reference in the program's place at a lower precision
(the configuration's ``control``): at every position of the same prompts
and frames it reads the gap of the token that the lower precision puts
first (or draws, for the sampled requests), and its codec's PCM against
the reference's; :func:`verdict` judges it as it judges the program.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from port_bench.reference.dac import DAC
from port_bench.reference.dual_ar import sampled_gaps, served_gaps
from port_bench.drive import SAMPLE_FRAMES as MIN_FRAMES
from port_bench.reference.prompt import prompt_matrix
from port_bench.reference.sampling import request_key

MOST = 6  # requests in the sample at most; it stops once it holds MIN_FRAMES frames


def reference(config: dict):
    """The LM reference module that ``config`` names (``"reference"``,
    default ``dual_ar``): ``reference/<stem>.py``."""
    return importlib.import_module(f"port_bench.reference.{config.get('reference', 'dual_ar')}")


def refuse(config: dict) -> None:
    """Raise, naming each key, when the configuration's ``model`` holds a
    key that its reference does not read, or leaves out or sets otherwise
    a flag that the reference computes at one value only."""
    ref = reference(config)
    model = config["model"]
    bad = [f"{k} (it reads no such key)" for k in model
           if k not in ref.FLAGS and k not in ref.SIZES]
    for k, v in ref.FLAGS.items():
        if k not in model:
            bad.append(f"{k} left out (it computes {v!r} only)")
        elif model[k] != v:
            bad.append(f"{k} = {model[k]!r} (it computes {v!r} only)")
    if bad:
        raise ValueError(f"configuration {config.get('name')!r}: its reference "
                         f"{config.get('reference', 'dual_ar')!r} does not compute "
                         + "; ".join(bad))


def frames_of(rec) -> int:
    return int(sum(c.shape[1] for c in rec.codes))


def sample(recs, seed: int, greedy: bool = True) -> list:
    """The finished greedy (or sampling) requests the reference judges: the
    longest, then others in an order drawn from ``seed``."""
    done = [r for r in recs if r.req.greedy == greedy and r.done_at is not None and r.codes]
    if not done:
        return []
    done.sort(key=lambda r: (-frames_of(r), r.req.index))
    out, rest = [done[0]], done[1:]
    total = frames_of(done[0])
    rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, 9 if greedy else 10])
    for i in rng.permutation(len(rest)):
        if total >= MIN_FRAMES or len(out) >= MOST:
            break
        out.append(rest[i])
        total += frames_of(rest[i])
    return out


class Judge:
    """The reference LM and codec of a configuration on its seeded weights."""

    def __init__(self, lm_params, codec_params, config: dict, ids, lm_mode: str,
                 codec_mode: str = "bf16"):
        self.ids = ids
        self.lm = reference(config).DualAR(lm_params, config["model"], ids, lm_mode)
        self.codec = DAC(codec_params, config["codec"], codec_mode)


NUMBERS = ("slow_gap", "fast_gap", "sampled_slow_gap", "sampled_fast_gap", "mean_gap",
           "pcm_err")


def _inputs(rec, traffic, config: dict, ids, device):
    """The request's prompt (1+K, T) and served frames (F, 1+K) on ``device``,
    and its codes (K, F)."""
    m = config["model"]
    codes = np.concatenate(rec.codes, axis=1)
    prompt = torch.from_numpy(prompt_matrix(rec.req.text, m["num_codebooks"],
                                            m["codebook_size"],
                                            traffic.voice_refs(rec.req))).to(device)
    frames = np.concatenate([codes[:1] + ids.semantic_begin, codes]).T
    return prompt, torch.from_numpy(np.ascontiguousarray(frames)).to(device), codes


def judge(greedy, sampled, traffic, config: dict, ref: Judge, controls: dict[str, Judge],
          device) -> tuple[dict, dict]:
    """The compared numbers of the two samples, and each control's."""
    fl = config["codec"]["frame_length"]
    got = {"frames_missing": 0.0, "pcm_samples_off": 0.0, "requests": 0.0, "frames": 0.0,
           "sampled_requests": 0.0, "sampled_frames": 0.0, "text_mass": 0.0, "ref_peak": 0.0,
           "ref_rms": 0.0,
           **{k: 0.0 for k in NUMBERS}}
    ctl = {name: {k: 0.0 for k in NUMBERS} for name in controls}
    sums = {name: [0.0, 0] for name in ("program", *controls)}

    def widest(into: dict, g: dict, prefix: str = "", who: str = "program") -> None:
        for k in ("slow_gap", "fast_gap"):
            into[prefix + k] = max(into[prefix + k], g[k])
        sums[who][0] += g["gap_sum"]
        sums[who][1] += g["tokens"]

    for rec in greedy:
        prompt, frames, codes = _inputs(rec, traffic, config, ref.ids, device)
        F = codes.shape[1]
        pcm = np.frombuffer(b"".join(rec.pcm), dtype=np.int16)
        got["requests"] += 1
        got["frames"] += F
        got["frames_missing"] += max(0, rec.req.frames - F)
        got["pcm_samples_off"] += abs(pcm.size - F * fl)
        widest(got, served_gaps(ref.lm, prompt, frames))
        codes_dev = torch.from_numpy(codes).to(device)
        want = ref.codec(codes_dev)
        got["ref_peak"] = max(got["ref_peak"], float(want.abs().max()))
        got["ref_rms"] = max(got["ref_rms"], float(want.square().mean().sqrt()))
        n = min(pcm.size, want.numel())
        served = torch.from_numpy(pcm[:n].astype(np.float32) / 32767.0).to(device)
        got["pcm_err"] = max(got["pcm_err"], float((served - want[:n]).abs().max()) if n else 0.0)
        for name, c in controls.items():
            widest(ctl[name], served_gaps(ref.lm, prompt, frames, chooser=c.lm), who=name)
            low = c.codec(codes_dev)
            ctl[name]["pcm_err"] = max(ctl[name]["pcm_err"], float((low - want).abs().max()))
    for rec in sampled:
        prompt, frames, codes = _inputs(rec, traffic, config, ref.ids, device)
        key, rules = request_key(rec.req.seed), rec.req.sampling
        got["sampled_requests"] += 1
        got["sampled_frames"] += codes.shape[1]
        got["frames_missing"] += max(0, rec.req.frames - codes.shape[1])
        g = sampled_gaps(ref.lm, prompt, frames, key, rules)
        widest(got, g, "sampled_")
        got["text_mass"] = max(got["text_mass"], g["text_mass"])
        for name, c in controls.items():
            widest(ctl[name], sampled_gaps(ref.lm, prompt, frames, key, rules, chooser=c.lm),
                   "sampled_", name)
    for name, into in (("program", got), *ctl.items()):
        total, n = sums[name]
        into["mean_gap"] = total / n if n else 0.0
    return got, ctl


def verdict(got: dict, limits: dict) -> tuple[bool, dict]:
    """Correct when neither sample is empty and every compared number is
    within its limit; the numbers beside their limits."""
    checks = {k: {"value": got[k], "limit": limits[k]} for k in limits}
    counts = {"judged_greedy": got["requests"], "judged_sampled": got["sampled_requests"]}
    ok = all(v > 0 for v in counts.values()) and all(
        c["value"] <= c["limit"] for c in checks.values())
    checks.update({k: {"value": v, "at_least": 1} for k, v in counts.items()})
    return ok, checks


def control_verdicts(got: dict, ctl: dict, limits: dict) -> dict:
    """Each control judged as the program is, on the program's samples."""
    out = {}
    for name, numbers in ctl.items():
        ok, _ = verdict({**got, **numbers}, limits)
        out[name] = {"correct": ok, **numbers}
    return out
