"""Run one cell of the benchmark once and print its result line.

    python -m port_bench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration (``configs/<name>.json``) and its traffic mix
(``traffic/<name>.json``) are found by the names in ``BENCHMARK.json``, the
metrics of the line by theirs (``metrics/<name>.py``).  A run:

1. refuses a configuration that its LM reference does not compute
   (``check.refuse``), makes the weights on the card from the seed, as the
   reference lists them, and builds ``FishTTS`` on them (the kernels'
   build is cached under ``build/`` in the checkout);
2. drives the mix (``drive.py``), warming every shape it will meet first;
   set-up ends when the window opens;
3. measures for ``--seconds`` (``--trace 1``: the last ``TRACE_S`` seconds
   of the window are traced on the device, and the line carries the
   per-layer metrics instead of the end-to-end ones);
4. reads the peak memory, frees the program, and has the reference judge
   what was served (``check.py``);
5. prints each compared number beside its limit on stderr, and last on
   stdout one JSON line with ``correct``, ``attempted``, ``failed``,
   ``metrics``, ``device`` (and ``breakdown`` when traced), then
   ``checks`` last.

Without a CUDA card, or with fewer than the cell's chips, it prints no
result and exits 2.  ``--control 1`` also reads the controls (the
reference at lower precisions in the program's place, ``check.py``) and
prints each one's verdict; ``--rate`` sets an open-loop mix's arrival
rate: both are for setting limits and rates, never for the benchmark's own
runs.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_S = 4.0  # the traced tail of the window, in seconds
FORBIDDEN = ("jax", "jaxlib", "flax", "fish_tts_tpu")


def _process_start() -> float:
    """This process's start on ``time.perf_counter``'s clock (Linux), or
    now."""
    now = time.perf_counter()
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return now - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return now


START = _process_start()


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = ROOT / "build"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(build / sub)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def config_of(raw: dict) -> dict:
    """A configuration file with its derived sizes."""
    cfg = json.loads(json.dumps(raw))
    v = cfg["codec"]
    v["latent_dim"] = v["encoder_dim"] * 2 ** len(v["encoder_rates"])
    hop = 1
    for r in v["encoder_rates"]:
        hop *= r
    for f in v["downsample_factor"]:
        hop *= f
    v["frame_length"] = hop
    v["init_std"] = cfg["weights"]["init_std"]
    cfg["model"].update(cfg["weights"])
    return cfg


def reader(name: str):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"port_bench.metrics.{name}",
                                                  HERE / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(man: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end ones, or with
    a trace its per-layer ones."""
    e2e = [m for m in man["end_to_end"] if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moves = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if cell in m.get("workloads", ()) or ("workloads" not in m and m["moves"] in moves)]


class Run:
    """What a metric reader reads: the harness's records of one run."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def build_program(config: dict, seed: int, device, tmp: Path):
    """``FishTTS`` on the seeded weights of ``config``, with the byte
    vocabulary written under ``tmp``."""
    import torch

    from fish_tts_tpu_torch.config import DualARConfig, VocoderConfig, VocoderTransformerConfig
    from fish_tts_tpu_torch.models.tokenizer import FishTokenizer
    from fish_tts_tpu_torch.synthesizer import FishTTS

    from port_bench import weights
    from port_bench.reference import prompt

    m, v = config["model"], config["codec"]
    vocab = tmp / "tokenizer.tiktoken"
    vocab.write_text(prompt.vocab_lines())
    tokenizer = FishTokenizer(vocab, prompt.special_tokens(m["codebook_size"]))
    ids = prompt.ids(m["codebook_size"])
    if (tokenizer.semantic_begin_id, tokenizer.im_end_id) != (ids.semantic_begin, ids.im_end):
        raise RuntimeError("the written vocabulary's ids differ from the reference's")
    fields = {f for f in DualARConfig.__dataclass_fields__}
    cfg = DualARConfig(**{k: val for k, val in m.items() if k in fields})
    vfields = {f for f in VocoderConfig.__dataclass_fields__} - {"quantizer_transformer",
                                                                 "latent_dim"}
    vcfg = VocoderConfig(
        **{k: tuple(val) if isinstance(val, list) else val for k, val in v.items()
           if k in vfields},
        quantizer_transformer=VocoderTransformerConfig(**v["quantizer_transformer"]))
    dtype = weight_dtype(config)
    params = lm_weights(config, seed, ids, device)
    vparams = weights.codec(v, seed, device, dtype)
    return FishTTS(device=device.type, precision=config["precision"], warmup=False,
                   _testing_bundle=(cfg, params, tokenizer, vcfg, vparams)), ids


def lm_weights(config: dict, seed: int, ids, device) -> dict:
    """The LM's seeded weights, drawn as the configuration's reference
    lists them (its ``lm_specs``, where it has one)."""
    from port_bench import check, weights

    specs = getattr(check.reference(config), "lm_specs", weights.lm_specs)
    return weights.lm(config["model"], seed, ids.semantic_begin, device, weight_dtype(config),
                      specs)


def weight_dtype(config: dict):
    """The dtype the weights are served in: float32 for an fp32
    configuration, else bfloat16 (int8 quantizes bf16 weights)."""
    import torch

    return torch.float32 if config["precision"] == "fp32" else torch.bfloat16


def run_cell(man: dict, cell: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, rate: float | None = None, config: dict | None = None,
             traffic_spec: dict | None = None, dump: str | None = None) -> dict:
    """One run of ``cell``; returns the result line's fields.  ``config``
    and ``traffic_spec`` replace the named files (tests); ``dump`` writes
    each request's record there."""
    import torch

    from port_bench import check, drive, weights
    from port_bench.reference.dual_ar import f32_only
    from port_bench.trace import Tracer, breakdown
    from port_bench.traffic import Traffic

    config = config or load_json("configs", cell["config"])
    check.refuse(config)
    config = config_of(config)
    spec = dict(traffic_spec or load_json("traffic", cell["traffic"]))
    if rate is not None:
        spec["rate_per_s"] = rate
    dev = torch.device(device)
    m, v = config["model"], config["codec"]
    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
        tts, ids = build_program(config, seed, dev, Path(tmp))
    traffic = Traffic(spec, seed, (m["num_codebooks"], v["semantic_codebook_size"],
                                   v["residual_codebook_size"]))
    clock = drive.Clock()
    tracer = Tracer() if trace and dev.type == "cuda" else None
    snaps = {}

    def on_open():
        if tracer is not None:
            tracer.warm()
        snaps["open"] = tts.get_metrics()["phases"]

    def on_close():
        if tracer is not None:
            tracer.stop()
        snaps["close"] = tts.get_metrics()["phases"]

    window = drive.Window(seconds, TRACE_S if tracer is not None else 0.0, on_open,
                          tracer.start if tracer is not None else None, on_close)
    out = drive.KINDS[spec["kind"]](tts, traffic, window, clock, tts.engine.engine_cfg)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    recs = out["recs"]
    run = Run(cell=cell["name"], config=config, spec=spec, traffic=traffic, recs=recs, t0=window.t0,
              t1=window.t1, close=window.close, setup_s=window.t0 - START, spans=clock.spans,
              lm_frames=out["lm_frames"], sample_rate=v["sample_rate"],
              phases=(snaps.get("open", {}), snaps.get("close", {})),
              timeline=None if tracer is None else tracer.timeline, ids=ids)
    if dump:
        write_records(dump, run)
    values = {}
    for metric in cell_metrics(man, cell["name"], trace):
        value = reader(metric["name"])(run)
        if value is not None:
            values[metric["name"]] = {"value": value, "unit": metric["unit"]}
    result = {
        "attempted": sum(1 for r in recs if r.due < window.close),
        "failed": sum(1 for r in recs if r.due < window.close and r.failed),
        "metrics": values,
        "device": {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": int(cell.get("chips", 1)), "memory_peak_bytes": int(peak)},
    }
    if dev.type == "cuda":
        result["device"]["power_limit"] = power_limit()
    if run.timeline is not None:
        result["device"]["busy_s"] = run.timeline.busy_s()
        result["device"]["window_s"] = run.timeline.window_s
        result["breakdown"] = breakdown(run.timeline, clock.spans)

    # the program is freed before the reference runs
    picked = check.sample(recs, seed), check.sample(recs, seed, greedy=False)
    del tts, out, run
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    f32_only()
    lm_w = lm_weights(config, seed, ids, dev)
    codec_w = weights.codec(v, seed, dev, weight_dtype(config))
    ref = check.Judge(lm_w, codec_w, config, ids, config["precision"])
    controls = {}
    if control:
        lms = config["control"]["lm"]
        for mode in [lms] if isinstance(lms, str) else lms:
            controls[mode] = check.Judge(lm_w, codec_w, config, ids, mode,
                                         config["control"]["codec"])
    got, ctl_got = check.judge(*picked, traffic, config, ref, controls, dev)
    ok, checks = check.verdict(got, config["limits"])
    result["sample"] = {k: got[k] for k in ("requests", "frames", "sampled_requests",
                                            "sampled_frames", "text_mass", "ref_peak",
                                            "ref_rms")}
    result["correct"] = ok and result["failed"] == 0
    if controls:
        result["control"] = check.control_verdicts(got, ctl_got, config["limits"])
    result["checks"] = checks
    return result


def write_records(path: str, run) -> None:
    """Each request's record, times from the window's opening."""
    with open(path, "w") as f:
        for r in run.recs:
            f.write(json.dumps({"index": r.req.index, "due": r.due - run.t0,
                                "frames": r.req.frames, "text": len(r.req.text),
                                "voice": r.req.voice, "greedy": r.req.greedy,
                                "deliveries": [(t - run.t0, n) for t, n in r.deliveries],
                                "done": None if r.done_at is None else r.done_at - run.t0})
                    + "\n")


def power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True).stdout
        return out.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the benchmark may not load."""
    return sorted({n.split(".", 1)[0] for n in sys.modules} & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--dump", default=None,
                    help="write each request's record (due, deliveries, frames) as JSON here")
    args = ap.parse_args(argv)
    cache_dirs()
    man = manifest()
    cells = {w["name"]: w for w in man["workloads"]}
    if args.workload not in cells:
        print(f"port_bench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"port_bench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(man, cell, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control), rate=args.rate, dump=args.dump)
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    print(f"sample: {json.dumps(result['sample'])}", file=sys.stderr)
    if "control" in result:
        print(f"control: {json.dumps(result['control'])}", file=sys.stderr)
    for name, c in result["checks"].items():
        bound = f"limit {c['limit']}" if "limit" in c else f"at least {c['at_least']}"
        print(f"check {name}: {c['value']} ({bound})", file=sys.stderr)
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    for k in ("breakdown", "control", "sample"):
        if k in result:
            line[k] = result[k]
    line["checks"] = result["checks"]
    print(json.dumps(line), flush=True)
    return 0
