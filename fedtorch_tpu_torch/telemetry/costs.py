"""Round cost capture and the device gauges (port of
``fedtorch_tpu/telemetry/costs.py``).

The JAX package reads a compiled round's cost from XLA
(``cost_analysis``, ``memory_analysis``). Eager torch compiles no
program, so the port measures the same quantities:

* **FLOPs**: ``torch.utils.flop_counter.FlopCounterMode`` over one
  training step's forward and backward on copies of the live params and
  one client batch (:func:`train_step_flops`), times the round's k x K
  steps, plus the work the counter cannot see: the hand flash forward
  (``ops/cuda/flash_attention.fwd_ops`` at the transformer's (B, T,
  heads, head dim) a layer, :func:`flash_kernel_ops`; on the CPU the
  plain version's matmuls are counted instead) and the ragged
  quantizer's elementwise operations, as XLA counts elementwise work
  (:data:`QDQ_OPS_PER_ELEM` an element, each uplink row and the
  downlink). The counter counts matmuls and convolutions only:
  elementwise work (the optimizer's, the norms', the activations')
  stays out, where XLA's count includes it. Nothing live is touched: the
  params are cloned, no generator draws.
* **Peak**: the H100's by compute dtype (:data:`H100_PEAK_TFLOPS`: 989
  TFLOP/s bf16 dense, 495 TF32 when float32 matmuls may use TF32, 67
  float32), or ``BENCH_PEAK_TFLOPS``. A round's flash forward is held
  to its own kernel's rate (:data:`FLASH_PEAK_TFLOPS`; float32's TF32
  kernel does three TF32 products for each), so the document's peak is
  the one that the round's FLOPs at their parts' rates would take
  (:func:`round_peak_tflops`). A run without a card is held to
  the H100's peak, the port's target (the source string says so);
  another card has no peak here and its FLOP gauges stay off.
* **Memory**: ``hbm_program_peak_bytes`` is
  ``torch.cuda.max_memory_allocated`` over round 0 (measured, where the
  JAX value is the program's static watermark), ``hbm_live_bytes``
  ``torch.cuda.memory_allocated()`` at row time (a host counter, no
  sync). Both are absent without CUDA (graceful None).

Contract (the JAX package's): the capture is taken once, after the first
round, by the writing process, and written as a schema-versioned
``program_costs.json`` that the JAX validators accept (the card's name
and power limit, as ``nvidia-smi`` gives them, ride in ``run``; the
count's breakdown too); a resumed run adopts the run directory's
document; a failed capture is logged and turns the gauges off, never
the run. The port's scan dispatch is a host loop over R rounds
(``parallel/round_program.py``), so its ``rounds_scan[R]`` entry is R
times the round's count.
"""
from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Optional, Tuple

PROGRAM_COSTS_SCHEMA = "fedtorch_tpu.program_costs/v1"

# the port's word in the flops_source vocabulary
FLOPS_COUNTER = "torch_flop_counter"

# resnet20-cifar forward = 40.8e6 MACs/image; a training step ~= 3x the
# forward, 2 FLOPs a MAC (the JAX package's analytic accounting)
ANALYTIC_MACS_PER_IMAGE = {"resnet20": 40.8e6}
_TRAIN_STEP_OVER_FWD = 3 * 2

# NVIDIA H100 SXM dense peaks, TFLOP/s
H100_PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}
# the flash forward's rate by compute dtype, TFLOP/s: the bf16 wgmma
# kernel at the bf16 peak; float32's TF32 kernel splits each product
# into three TF32 products (3xTF32)
FLASH_PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 495.0 / 3}
# the ragged quantizer's operations an element: 3 in the stats pass
# (min, max, sum), 9 in the round trip
QDQ_OPS_PER_ELEM = 3 + 9


def analytic_train_flops_per_image(arch: str) -> Optional[float]:
    """Hand-derived training FLOPs per image where a constant exists
    (the north-star resnet20); None elsewhere."""
    macs = ANALYTIC_MACS_PER_IMAGE.get(arch)
    return _TRAIN_STEP_OVER_FWD * macs if macs is not None else None


_SMI = ["nvidia-smi", "--query-gpu=name,power.limit",
        "--format=csv,noheader"]


def _start_card_probe():
    """``nvidia-smi`` started without waiting (it takes up to a second
    to start; a run reads it after its first round); None without it."""
    try:
        return subprocess.Popen(_SMI, stdout=subprocess.PIPE,
                                stderr=subprocess.DEVNULL, text=True)
    except OSError:
        return None


def card_info(probe=None) -> Optional[Dict[str, str]]:
    """``{"name", "power_limit"}`` of card 0 as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (from ``probe``, a :func:`_start_card_probe` process, when given);
    None without the tool or a card."""
    proc = probe or _start_card_probe()
    if proc is None:
        return None
    try:
        out, _ = proc.communicate(timeout=30)
    except subprocess.SubprocessError:
        proc.kill()
        proc.communicate()
        return None
    line = out.strip().splitlines()[0] if out.strip() else ""
    if proc.returncode != 0 or "," not in line:
        return None
    name, limit = (v.strip() for v in line.split(",", 1))
    return {"name": name, "power_limit": limit}


def _tf32_matmuls() -> bool:
    import torch
    return bool(torch.backends.cuda.matmul.allow_tf32) or \
        torch.get_float32_matmul_precision() != "highest"


def resolve_peak_tflops(dtype: str = "float32",
                        device_name: Optional[str] = None
                        ) -> Tuple[Optional[float], str]:
    """(peak TFLOP/s a card, source): ``BENCH_PEAK_TFLOPS`` when set,
    else the H100's for ``dtype`` (``float32`` reads as TF32 when
    float32 matmuls may use it) when ``device_name`` names an H100 or
    no card is in use (None); another card: (None, why)."""
    env = os.environ.get("BENCH_PEAK_TFLOPS")
    if env:
        return float(env), "env:BENCH_PEAK_TFLOPS"
    key = dtype if dtype in H100_PEAK_TFLOPS else "float32"
    if key == "float32" and _tf32_matmuls():
        key = "tf32"
    if device_name is None:
        return H100_PEAK_TFLOPS[key], \
            f"default:h100:{key} (no card in use: the port's target)"
    if "H100" in device_name:
        return H100_PEAK_TFLOPS[key], f"default:h100:{key}"
    return None, f"no peak known for {device_name!r}"


def round_peak_tflops(counted: Dict[str, float], dtype: str = "float32",
                      device_name: Optional[str] = None
                      ) -> Tuple[Optional[float], str]:
    """(peak TFLOP/s, source) for :func:`round_flops`'s breakdown: the
    peak at which the round's FLOPs take as long as its parts at their
    own rates, the flash forward at :data:`FLASH_PEAK_TFLOPS` and the
    rest at :func:`resolve_peak_tflops`'s; that peak alone where no
    flash forward ran or ``BENCH_PEAK_TFLOPS`` is set."""
    peak, source = resolve_peak_tflops(dtype, device_name)
    flash = counted.get("step_flash_kernel", 0.0) * counted.get("steps", 0.0)
    if peak is None or not flash or source.startswith("env:"):
        return peak, source
    fpeak = FLASH_PEAK_TFLOPS.get(dtype, FLASH_PEAK_TFLOPS["float32"])
    rest = counted["round"] - flash
    return (counted["round"] / (rest / peak + flash / fpeak),
            f"{source}; the flash forward at {fpeak:g}")


# -- the count ----------------------------------------------------------


def flash_kernel_ops(model, bx) -> float:
    """The hand flash forward's operations in one forward of the batch
    ``bx`` (the counter cannot see a kernel that is no aten op): each
    layer's causal attention at (B, T, heads, head dim), where the model
    is the transformer, its attention takes the flash route at T and the
    batch lies on a card; else 0 (on the CPU the plain version's matmuls
    are aten ops, counted)."""
    from fedtorch_tpu_torch.models.transformer import TransformerLM
    from fedtorch_tpu_torch.ops.attention_dispatch import resolve_attention
    from fedtorch_tpu_torch.ops.cuda.flash_attention import fwd_ops
    m = getattr(model, "module", None)
    if not isinstance(m, TransformerLM) or bx.device.type != "cuda":
        return 0.0
    B, T = bx.shape[:2]
    if resolve_attention(m.attention, T) != "flash":
        return 0.0
    d = m.pos_embed.shape[1]
    return m.num_layers * fwd_ops(B, T, m.num_heads, d // m.num_heads,
                                  True)


def train_step_flops(model, params: Dict, bx, by) -> Dict[str, float]:
    """One training step's forward and backward, the model's own loss
    (``make_criterion``), on copies of ``params`` and the batch (``bx``,
    ``by``): ``{"counted": FlopCounterMode's total, "flash_kernel":
    :func:`flash_kernel_ops`}``."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from fedtorch_tpu_torch.core.losses import make_criterion

    criterion = make_criterion(model.is_regression)
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    with FlopCounterMode(display=False) as counter:
        if model.is_recurrent:
            logits, _ = model.apply(leaves, bx,
                                    model.init_carry(bx.shape[0]))
        elif model.has_aux_loss:
            logits, _ = model.apply_with_aux(leaves, bx, train=True)
        else:
            logits = model.apply(leaves, bx, train=True)
        loss = criterion(logits, by)
        torch.autograd.grad(loss, list(leaves.values()))
    return {"counted": float(counter.get_total_flops()),
            "flash_kernel": flash_kernel_ops(model, bx)}


def round_flops(trainer, params: Dict, bx, by) -> Dict[str, float]:
    """The breakdown of one round's (one commit's) FLOPs: a step's
    counted and flash FLOPs, the steps a round takes (the dispatched
    clients' or a commit's buffer, times K), the quantizer's elementwise
    operations and the ``round`` total."""
    step = train_step_flops(trainer.model, params, bx, by)
    width = getattr(trainer, "buffer_size", None) or trainer.k_online
    steps = float(width * trainer.local_steps)
    fed = trainer.cfg.federated
    n_params = float(sum(v.numel() for v in params.values()))
    # each uplink row and the downlink, int8 both ways
    quant = QDQ_OPS_PER_ELEM * (width + 1) * n_params \
        if fed.quantized else 0.0
    total = steps * (step["counted"] + step["flash_kernel"]) + quant
    return {"step_counted": step["counted"],
            "step_flash_kernel": step["flash_kernel"], "steps": steps,
            "quantizer": quant, "round": total}


# -- the program_costs.json document (the JAX package's v1 contract) ----

PROGRAM_FIELDS = {
    "flops": "FLOPs of the program (the port: counted, see costs.py)",
    "transcendentals": "transcendental op count",
    "bytes_accessed": "bytes read+written by the program",
    "argument_bytes": "input buffer bytes",
    "output_bytes": "output buffer bytes",
    "temp_bytes": "intermediate buffer bytes",
    "generated_code_bytes": "executable code bytes",
    "alias_bytes": "donated input bytes reused as outputs",
    "peak_hbm_bytes": "device-memory peak (the port: "
                      "max_memory_allocated over round 0)",
    "flops_source": "torch_flop_counter, xla_cost_analysis or None",
    "error": "capture failure note (program still listed)",
}

_TOP_REQUIRED = ("schema", "created_unix", "backend", "num_devices",
                 "compute_dtype", "peak_tflops_per_chip", "peak_source",
                 "programs")
_TOP_OPTIONAL = ("run", "analytic", "primary")


def validate_program_costs(doc: Dict) -> None:
    """Raise ``ValueError`` when ``doc`` violates the v1 contract (the
    JAX package's rules)."""
    if doc.get("schema") != PROGRAM_COSTS_SCHEMA:
        raise ValueError(
            f"program_costs schema {doc.get('schema')!r} != "
            f"{PROGRAM_COSTS_SCHEMA!r}")
    for key in _TOP_REQUIRED:
        if key not in doc:
            raise ValueError(f"program_costs missing required {key!r}")
    unknown = [k for k in doc
               if k not in _TOP_REQUIRED and k not in _TOP_OPTIONAL]
    if unknown:
        raise ValueError(f"program_costs carries uncataloged top-level "
                         f"fields {unknown!r}")
    programs = doc["programs"]
    if not isinstance(programs, dict) or not programs:
        raise ValueError("program_costs 'programs' must be a non-empty "
                         "dict of program-name -> cost summary")
    for name, rec in programs.items():
        if not isinstance(rec, dict):
            raise ValueError(f"program {name!r} record must be a dict")
        bad = [k for k in rec if k not in PROGRAM_FIELDS]
        if bad:
            raise ValueError(f"program {name!r} carries uncataloged "
                             f"fields {bad!r}")
        for k, v in rec.items():
            if k in ("flops_source", "error"):
                if v is not None and not isinstance(v, str):
                    raise ValueError(
                        f"program {name!r} field {k!r} must be str or "
                        f"None, got {type(v).__name__}")
            elif v is not None and (isinstance(v, bool)
                                    or not isinstance(v, (int, float))):
                raise ValueError(
                    f"program {name!r} field {k!r} must be numeric or "
                    f"None, got {type(v).__name__} ({v!r})")


def program_costs_path(run_dir: str) -> str:
    return os.path.join(run_dir, "program_costs.json")


def read_program_costs(run_dir: str) -> Optional[Dict]:
    """The validated document, or None when the run never captured."""
    path = program_costs_path(run_dir)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        doc = json.load(f)
    validate_program_costs(doc)
    return doc


def _cuda_ready() -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.is_initialized()


class ProgramCostCapture:
    """Once-per-run cost capture and the per-round device gauges.

    Built by the CLI loop (the writing process, telemetry on);
    :meth:`capture` runs once right after the first round and writes
    ``program_costs.json`` atomically; :meth:`round_gauges` then turns
    each round's wall into the MFU and memory fields from host state
    alone. Attempt-once: a failed capture is logged and never retried,
    and never raises."""

    def __init__(self, run_dir: str, *, compute_dtype: str = "float32",
                 arch: Optional[str] = None,
                 batch_size: Optional[int] = None,
                 local_steps: Optional[int] = None,
                 k_online: Optional[int] = None, num_devices: int = 1,
                 backend: Optional[str] = None,
                 device_name: Optional[str] = None,
                 primary: str = "round", scan_rounds: int = 0,
                 run_meta: Optional[Dict] = None, log=None):
        self.run_dir = run_dir
        self.compute_dtype = compute_dtype
        self.arch = arch
        self.batch_size = batch_size
        self.local_steps = local_steps
        self.k_online = k_online
        self.num_devices = max(int(num_devices), 1)
        self.backend = backend
        self.primary = primary
        self.scan_rounds = int(scan_rounds)
        self.run_meta = dict(run_meta or {})
        self.log = log or (lambda *_: None)
        self.device_name = device_name
        self.peak_tflops, self.peak_source = resolve_peak_tflops(
            compute_dtype, device_name)
        self.captured = False
        self.doc: Optional[Dict] = None
        self._primary: Optional[Dict] = None
        # the card's name and power limit, read beside the first round
        self._card_probe = _start_card_probe() \
            if backend == "cuda" else None

    def _card(self) -> Optional[Dict[str, str]]:
        probe, self._card_probe = self._card_probe, None
        return card_info(probe) if probe is not None else None

    def load_existing(self) -> bool:
        """Adopt a previous attempt's ``program_costs.json`` instead of
        capturing again (a resumed run: its round 0 is long past)."""
        try:
            doc = read_program_costs(self.run_dir)
        except (ValueError, OSError, json.JSONDecodeError):
            return False
        if doc is None:
            return False
        self._card()  # the probe is not needed: reap it
        self.captured = True
        self.doc = doc
        self.peak_tflops = doc.get("peak_tflops_per_chip")
        self._primary = doc["programs"].get(doc.get("primary"))
        self.log("cost capture: adopted existing program_costs.json "
                 f"(primary {doc.get('primary')!r}"
                 + ("" if self._primary is not None
                    else " — not found, device gauges off") + ")")
        return True

    def _analytic_block(self) -> Optional[Dict]:
        if self.arch is None:
            return None
        per_image = analytic_train_flops_per_image(self.arch)
        block: Dict = {"arch": self.arch,
                       "train_flops_per_image": per_image}
        if per_image is not None and self.batch_size \
                and self.local_steps and self.k_online:
            block["round_flops"] = (per_image * self.batch_size
                                    * self.local_steps * self.k_online)
        return block

    def capture(self, counted: Dict[str, float],
                peak_bytes: Optional[float] = None) -> Optional[Dict]:
        """Write ``program_costs.json`` from :func:`round_flops`'s
        breakdown and round 0's measured memory peak (None without
        CUDA). Absorbs every failure."""
        self.captured = True  # attempt-once, success or not
        try:
            self.peak_tflops, self.peak_source = round_peak_tflops(
                counted, self.compute_dtype, self.device_name)
            rec = {"flops": float(counted["round"]),
                   "flops_source": FLOPS_COUNTER,
                   "peak_hbm_bytes": None if peak_bytes is None
                   else float(peak_bytes)}
            programs = {self.primary: rec}
            if self.scan_rounds > 0:
                # the port's scan is a host loop: R rounds' work
                name = "rounds_stream_scan" \
                    if self.primary.endswith("_stream") else "rounds_scan"
                programs[f"{name}[{self.scan_rounds}]"] = dict(
                    rec, flops=rec["flops"] * self.scan_rounds)
            card = self._card()
            doc = {
                "schema": PROGRAM_COSTS_SCHEMA,
                "created_unix": time.time(),
                "backend": self.backend,
                "num_devices": self.num_devices,
                "compute_dtype": self.compute_dtype,
                "peak_tflops_per_chip": self.peak_tflops,
                "peak_source": self.peak_source,
                "primary": self.primary,
                "programs": programs,
                "run": dict(self.run_meta, card=card,
                            flops_breakdown=dict(counted)),
            }
            analytic = self._analytic_block()
            if analytic is not None:
                doc["analytic"] = analytic
            validate_program_costs(doc)
            self._write(doc)
            self.doc = doc
            self._primary = rec
            self.log(f"cost capture: {len(programs)} program(s) -> "
                     f"{program_costs_path(self.run_dir)} (primary "
                     f"{self.primary!r}, flops={rec['flops']:.6g}, peak "
                     f"{self.peak_tflops} TFLOP/s {self.peak_source}"
                     + (f", {card['name']}, {card['power_limit']}"
                        if card else "") + ")")
            return doc
        except Exception as e:
            self.log(f"cost capture failed ({type(e).__name__}: "
                     f"{str(e)[:160]}); training continues without "
                     "device gauges")
            return None

    def _write(self, doc: Dict) -> None:
        """Atomic replace: a reader never sees a torn document."""
        path = program_costs_path(self.run_dir)
        tmp = path + ".tmp"
        os.makedirs(self.run_dir, exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def round_gauges(self, round_s: float) -> Dict[str, float]:
        """The metrics-row fields this capture adds, all host-side:
        ``model_flops_utilization`` (round FLOPs / (round wall x peak x
        cards)), ``round_device_min_s`` and ``round_host_frac`` (the
        FLOPs-at-peak floor and the wall share it does not explain), and
        on CUDA ``hbm_program_peak_bytes`` and ``hbm_live_bytes``. Empty
        until :meth:`capture` (or the adoption) succeeded."""
        if self._primary is None:
            return {}
        out: Dict[str, float] = {}
        flops = self._primary.get("flops")
        if flops and self.peak_tflops and round_s > 0:
            floor = flops / (self.peak_tflops * 1e12 * self.num_devices)
            out["model_flops_utilization"] = floor / round_s
            out["round_device_min_s"] = floor
            out["round_host_frac"] = min(max(1.0 - floor / round_s, 0.0),
                                         1.0)
        peak = self._primary.get("peak_hbm_bytes")
        if peak is not None:
            out["hbm_program_peak_bytes"] = float(peak)
        if _cuda_ready():
            import torch
            out["hbm_live_bytes"] = float(torch.cuda.memory_allocated())
        return out
