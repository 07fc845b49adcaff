"""simlint — the reference's structural invariants, checked on the PyTorch
engine (the port of ``repro.analysis.simlint``).

The engine's results rest on structural properties that no parity test
sees: phase skips that really skip work, observers without effects, shapes
that do not depend on data, one operator program across knob values, and
launch plans inside the card's limits.  The reference reads them off
jaxprs and XLA's optimized HLO.  PyTorch has neither, so the port reads
them off the engine as it runs: a ``TorchDispatchMode`` records every
operator a batch step enqueues (its name, input shapes, dtypes and
devices), the host reads among them (``aten._local_scalar_dense``, a copy
from a CUDA tensor to the CPU), the gates that ``step.host_any`` counts,
the phases a step entered, and the launch plans of the four kernels.  The
engine is read, never changed: the recording wraps module attributes
(``provision.provision_due_vms``, ``engine.batch_event_step``, ...) for the
length of a probe and restores them.

Rules:

=====  ==================  =====================================================
R1     cond-not-select     phase skips are real: in each batch step of
                           ``simulate``, ``batch`` and ``campaign_sharded``,
                           provision, dispatch and transfer are entered exactly
                           when their ``host_any`` gate read True; a skipped
                           phase enqueues no operator; each gate is one counted
                           sync (the step's host reads == its ``host_any.syncs``)
R2     donation-aliases    chunks do not outlive their fold: under
                           ``run_campaign(chunk_size=, reduce=)`` (local and on
                           a one-rank mesh) no tensor of chunk k (scenario,
                           final state, result) is referenced when chunk k+1
                           starts; on the card the peak memory above the held
                           baseline of 8 chunks equals 2 chunks' within 1 MiB
R3     pure-observer       the drivers read the host only through
                           ``host_any``; no hook (``pre``, ``bound``, ``post``,
                           ``finalize``) of any instrument ``instruments_for``
                           attaches reads the host or writes a tensor it was
                           given (``_version`` of every input leaf); on the card
                           the hooks also run under
                           ``torch.cuda.set_sync_debug_mode("error")``
R4     shape-stable-scan   no data-dependent shapes in a step (``nonzero``,
                           ``masked_select``, ``unique``, boolean-mask indexing,
                           ``repeat_interleave`` without ``output_size``); every
                           ``SimState`` leaf keeps its shape step to step;
                           ``init_state`` at B=1 and B=4 differ only in the
                           leading dimension
R5     recompile-hazard    one operator program across knob values: batch steps
                           with equal gate outcomes record equal ``(op, shapes,
                           dtypes)`` sequences for Fig. 4 and its ``TIME_SHARED``
                           variant, and for the 4-row batch and
                           ``broadcast_campaign(variant, 4)``; two
                           successive-halving runs load each kernel library at
                           most once and record equal fold traces for equal
                           chunk shapes
R6     kernel-budget       the launch plans of the advance sweep, the flash
                           forward and backward and the SSD scan stay inside
                           Hopper's limits (threads <= 1,024 and a multiple of
                           32, of 128 for a ``wgmma`` kernel; dynamic shared
                           memory <= 232,448 bytes; grid.x < 2^31, grid.y and
                           grid.z <= 65,535; the sweep fused iff its row fits
                           ``FUSED_CAP``); on the card each plan's threads and
                           shared memory equal the built library's
=====  ==================  =====================================================

The rule bodies are thin wrappers over pure ``check_*`` functions of
recorded artifacts (``StepRecord``s, op traces, plans), so tests can feed
doctored ones: a phase entered without its gate, a chunk runner that keeps
its results, a hook that calls ``.item()``, a step that calls ``nonzero``, a
knob turned into a Python branch, a plan past a limit.

Every probe runs on the ``LintContext``'s device: ``None`` means the GPU
and raises without one, so the CPU must be asked for (``device="cpu"``).
On the card the advance entry is the CUDA sweep, on the CPU its plain
version.

CLI: ``scripts/simlint_torch.py`` (report, ``--json``, ``--rule`` /
``--entry`` filters, ``--device``; exit 1 on an error finding).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import weakref
from typing import Callable, Iterable

import torch
from torch import Tensor
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.entities import resolve_device

# ---------------------------------------------------------------------------
# findings + rule registry
# ---------------------------------------------------------------------------

SEVERITIES = ("error", "warning", "info")


@dataclasses.dataclass
class Finding:
    """One structured lint result."""

    rule: str          # "R1" ... "R6"
    name: str          # rule slug, e.g. "cond-not-select"
    severity: str      # "error" | "warning" | "info"
    entry_point: str   # entry (or "instrument:<name>.<hook>") it was found in
    message: str       # what is wrong (or noteworthy)
    evidence: str = ""  # recorded ops or plan backing the finding

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Rule:
    rule: str
    name: str
    entries: tuple     # entry points this rule reads (for --entry filtering)
    fn: Callable       # fn(ctx) -> list[Finding]
    doc: str


RULES: dict[str, Rule] = {}


def rule(rule_id: str, name: str, entries: tuple):
    def deco(fn):
        RULES[rule_id] = Rule(
            rule=rule_id, name=name, entries=entries, fn=fn,
            doc=(fn.__doc__ or "").strip().split("\n")[0],
        )
        return fn
    return deco


def _finding(rule_id: str, severity: str, entry: str, message: str,
             evidence: str = "") -> Finding:
    spec = RULES[rule_id]
    return Finding(rule=rule_id, name=spec.name, severity=severity,
                   entry_point=entry, message=message,
                   evidence=evidence.strip()[:500])


# ---------------------------------------------------------------------------
# recording: the operators a piece of the engine enqueues
# ---------------------------------------------------------------------------

# ops whose output shape depends on the data (R4), by overload packet
_DYNAMIC_OPS = {
    "aten.nonzero": "nonzero", "aten.argwhere": "argwhere",
    "aten.masked_select": "masked_select", "aten.unique": "unique",
    "aten._unique": "unique", "aten._unique2": "unique",
    "aten.unique_dim": "unique", "aten.unique_consecutive": "unique",
}
_INDEX_OPS = ("aten.index", "aten.index_put", "aten.index_put_",
              "aten._index_put_impl_")
_HOST_READ_OPS = ("aten._local_scalar_dense",)
_COPY_OPS = ("aten._to_copy", "aten.copy_")


@dataclasses.dataclass(frozen=True)
class OpRecord:
    """One dispatched operator: its name, the shapes, dtypes and device
    types of its tensor inputs, why its output shape depends on the data
    (None when it does not), and whether it read a value on the host (the
    value read, for a gate)."""

    op: str
    shapes: tuple
    dtypes: tuple
    devices: tuple
    dynamic: str | None = None
    host_read: bool = False
    value: object = None

    def signature(self) -> tuple:
        """``(op, shapes, dtypes)``: what R5 compares."""
        return (self.op, self.shapes, self.dtypes)


def _packet(func) -> str:
    """``aten.index`` for ``aten.index.Tensor``."""
    return str(getattr(func, "overloadpacket", func))


def _dynamic_reason(func, args, kwargs) -> str | None:
    pkt = _packet(func)
    if pkt in _DYNAMIC_OPS:
        return _DYNAMIC_OPS[pkt]
    if pkt in _INDEX_OPS and len(args) > 1:
        idx = args[1] if isinstance(args[1], (list, tuple)) else ()
        if any(isinstance(t, Tensor) and t.dtype in (torch.bool, torch.uint8)
               for t in idx):
            return "boolean-mask indexing"
    if pkt == "aten.repeat_interleave" and kwargs.get("output_size") is None:
        if any(isinstance(a, Tensor) for a in args[:2]):
            return "repeat_interleave without output_size"
    return None


def _host_read(func, args, kwargs, out) -> bool:
    pkt = _packet(func)
    if pkt in _HOST_READ_OPS:
        return True
    if pkt in _COPY_OPS:
        src = [t for t in pytree.tree_leaves((args, kwargs))
               if isinstance(t, Tensor)]
        if pkt == "aten.copy_" and len(src) >= 2:
            return src[0].device.type == "cpu" and src[1].device.type == "cuda"
        dst = out if isinstance(out, Tensor) else None
        return (dst is not None and dst.device.type == "cpu"
                and any(t.device.type == "cuda" for t in src))
    return False


class OpRecorder(TorchDispatchMode):
    """Records every operator dispatched under it (``ops``), also one that
    raises (a host read refused by ``set_sync_debug_mode("error")``)."""

    def __init__(self):
        super().__init__()
        self.ops: list[OpRecord] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = None
        try:
            out = func(*args, **kwargs)
            return out
        finally:
            leaves = [t for t in pytree.tree_leaves((args, kwargs))
                      if isinstance(t, Tensor)]
            read = _host_read(func, args, kwargs, out)
            self.ops.append(OpRecord(
                op=str(func),
                shapes=tuple(tuple(t.shape) for t in leaves),
                dtypes=tuple(str(t.dtype) for t in leaves),
                devices=tuple(t.device.type for t in leaves),
                dynamic=_dynamic_reason(func, args, kwargs),
                host_read=read,
                value=out if read and not isinstance(out, Tensor) else None,
            ))


@contextlib.contextmanager
def wrapped(owner, name: str, make: Callable):
    """``owner.name`` replaced by ``make(original)`` inside the block, the
    original restored after (the lint's only way into the engine)."""
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield orig
    finally:
        setattr(owner, name, orig)


# ---------------------------------------------------------------------------
# step records: what one batch step did
# ---------------------------------------------------------------------------

# the gated phases of ``step.batch_event_step``, in the order their gates
# are read, and the functions they enter (reached through the module)
PHASES = (("provision", "provision_due_vms"),
          ("dispatch", "dispatch_cloudlets"),
          ("transfer", "transfer_phase"))


@dataclasses.dataclass
class StepRecord:
    """One batch step as recorded: for each ``host_any`` call (a gate, in
    order) the value it read on the host and the value it returned, the
    phases the step entered (in order) and the operators each enqueued,
    ``host_any.syncs``' move over the step, the number of host reads, the
    step's operators and its state's leaf shapes."""

    gates: list = dataclasses.field(default_factory=list)
    returns: list = dataclasses.field(default_factory=list)
    entered: list = dataclasses.field(default_factory=list)
    phase_ops: dict = dataclasses.field(default_factory=dict)
    syncs: int = 0
    host_reads: int = 0
    ops: list = dataclasses.field(default_factory=list)
    state_shapes: dict = dataclasses.field(default_factory=dict)

    def key(self) -> tuple:
        """The gate outcomes: R5 compares steps with equal keys."""
        return tuple(bool(g) for g in (self.returns or self.gates))

    def signature(self) -> tuple:
        return tuple(op.signature() for op in self.ops)


class _Gate:
    """``step.host_any`` seen through: each call inside a recorded step
    logs the value it read on the host (the last host read it made) and
    the value it returned; ``syncs`` is the wrapped function's counter."""

    def __init__(self, orig, rec: OpRecorder, current: list):
        self.orig, self.rec, self.current = orig, rec, current

    @property
    def syncs(self):
        return self.orig.syncs

    @syncs.setter
    def syncs(self, value):
        self.orig.syncs = value

    def __call__(self, x):
        n0 = len(self.rec.ops)
        out = self.orig(x)
        if self.current:
            reads = [op.value for op in self.rec.ops[n0:] if op.host_read]
            self.current[-1].gates.append(reads[-1] if reads else out)
            self.current[-1].returns.append(out)
        return out


@dataclasses.dataclass
class RunRecord:
    """A whole driver call: its batch steps, and over the call the host
    reads and ``host_any.syncs``' move (driver loop tests included)."""

    steps: list
    host_reads: int
    syncs: int


def _state_shapes(st) -> dict:
    return {f.name: tuple(getattr(st, f.name).shape)
            for f in dataclasses.fields(st)
            if isinstance(getattr(st, f.name), Tensor)}


def record_run(fn: Callable, *args, **kwargs) -> tuple[object, RunRecord]:
    """Run ``fn`` (a driver) with every batch step recorded."""
    from repro_torch.core import engine, provision, step

    rec = OpRecorder()
    steps: list[StepRecord] = []
    current: list[StepRecord] = []

    def step_wrapper(orig):
        def batch_event_step(scn_b, carry, ctx, live):
            cur = StepRecord()
            current.append(cur)
            n0, s0 = len(rec.ops), step.host_any.syncs
            out = orig(scn_b, carry, ctx, live)
            current.pop()
            cur.ops = rec.ops[n0:]
            cur.syncs = step.host_any.syncs - s0
            cur.host_reads = sum(op.host_read for op in cur.ops)
            cur.state_shapes = _state_shapes(out[0][0])
            steps.append(cur)
            return out
        return batch_event_step

    def phase_wrapper(label):
        def make(orig):
            def phase(*a, **k):
                n0 = len(rec.ops)
                out = orig(*a, **k)
                if current:
                    current[-1].entered.append(label)
                    current[-1].phase_ops[label] = len(rec.ops) - n0
                return out
            return phase
        return make

    with contextlib.ExitStack() as stack:
        stack.enter_context(wrapped(engine, "batch_event_step", step_wrapper))
        stack.enter_context(wrapped(step, "host_any",
                                    lambda orig: _Gate(orig, rec, current)))
        for label, fn_name in PHASES:
            stack.enter_context(wrapped(provision, fn_name,
                                        phase_wrapper(label)))
        s0 = step.host_any.syncs
        with rec:
            out = fn(*args, **kwargs)
        syncs = step.host_any.syncs - s0
    return out, RunRecord(steps=steps,
                          host_reads=sum(op.host_read for op in rec.ops),
                          syncs=syncs)


# ---------------------------------------------------------------------------
# the lint context: subjects built lazily, artifacts cached
# ---------------------------------------------------------------------------

# Entry points of the default lint run.  ``batch`` is ``simulate`` on a
# stacked campaign of 4 rows; ``campaign_chunk`` is ``run_campaign(
# chunk_size=, reduce=)`` (the streamed fold and the successive-halving
# search over it); ``campaign_sharded`` is ``run_campaign(mesh=,
# axis="data")`` on a one-rank group (gloo on the CPU, NCCL on the card);
# ``advance`` is the advance sweep for the context's device: the CUDA
# kernel on the card, its plain version on the CPU.
ENTRY_NAMES = (
    "simulate",
    "simulate_trace",
    "simulate_history",
    "batch",
    "campaign_chunk",
    "campaign_sharded",
    "advance",
)

_BATCH = 4          # rows in the stacked-campaign entry
_TRACE_SAMPLES = 4  # sample points for the simulate_trace entry


class LintContext:
    """Builds each artifact a rule reads at most once, on ``device``
    (``None``: the GPU).  ``entries`` restricts which entry points may run
    at all (the ``--entry`` filter).  Use it as a context manager: a
    process group it started for ``campaign_sharded`` ends with it."""

    def __init__(self, entries: Iterable[str] | None = None, device=None):
        self.allowed = tuple(entries) if entries else ENTRY_NAMES
        unknown = set(self.allowed) - set(ENTRY_NAMES)
        if unknown:
            raise ValueError(
                f"unknown entry point(s) {sorted(unknown)}; "
                f"known: {list(ENTRY_NAMES)}"
            )
        self.device = resolve_device(device)
        self._cache: dict = {}
        self._own_group = False

    def wants(self, entry: str) -> bool:
        return entry in self.allowed

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def close(self) -> None:
        if self._own_group:
            import torch.distributed as dist
            dist.destroy_process_group()
            self._own_group = False
        self._cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def cached(self, key, build: Callable):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def get(self, key):
        """An artifact built already (``("run", entry)``, ``"r2_peaks"``,
        ...), or None."""
        return self._cache.get(key)

    # -- subjects ----------------------------------------------------------
    def _with_topology(self, scn):
        """A 1-DC uniform topology, so the transfer phase and its gate exist
        in every linted step (R1, R5)."""
        from repro_torch.core.energy import Topology
        return scn.replace(topology=Topology.uniform(1, device=self.device))

    def scenario(self):
        """The canonical single-scenario lint subject (paper Figure 4)."""
        from repro_torch.core import scenarios
        from repro_torch.core.entities import SPACE_SHARED
        return self.cached("scn", lambda: self._with_topology(
            scenarios.fig4_scenario(SPACE_SHARED, SPACE_SHARED,
                                    device=self.device)))

    def scenario_variant(self):
        """Same shapes as ``scenario()``, other knob values (R5)."""
        from repro_torch.core import scenarios
        from repro_torch.core.entities import TIME_SHARED
        return self.cached("scn_variant", lambda: self._with_topology(
            scenarios.fig4_scenario(TIME_SHARED, TIME_SHARED, length_mi=1000.0,
                                    device=self.device)))

    def batch_scenario(self):
        """A stacked campaign of 4 rows (the batch-major path)."""
        from repro_torch.core import campaign, scenarios
        from repro_torch.core.entities import SPACE_SHARED

        def build():
            rows = [self._with_topology(scenarios.fig4_scenario(
                SPACE_SHARED, SPACE_SHARED, length_mi=m, device=self.device))
                for m in (1000.0, 2000.0, 3000.0, 4000.0)[:_BATCH]]
            return campaign.stack_scenarios(rows)
        return self.cached("scn_batch", build)

    def mesh(self):
        """A one-rank ``("data",)`` mesh; starts a process group of one
        rank (gloo on the CPU, NCCL on the card) when none is running."""
        def build():
            import torch.distributed as dist

            from repro_torch.launch.mesh import make_host_mesh
            if not dist.is_initialized():
                dist.init_process_group(
                    "nccl" if self.on_card else "gloo",
                    store=dist.HashStore(), rank=0, world_size=1)
                self._own_group = True
            return make_host_mesh((1,), ("data",))
        return self.cached("mesh", build)

    # -- artifacts ---------------------------------------------------------
    def entry_call(self, entry: str):
        """``(fn, args, kwargs)`` of an engine entry point."""
        from repro_torch.core import campaign, engine
        dev = self.device
        if entry == "simulate":
            return engine.simulate, (self.scenario(),), {"device": dev}
        if entry == "simulate_trace":
            ts = torch.linspace(0.0, 400.0, _TRACE_SAMPLES)
            return (engine.simulate_trace, (self.scenario(), ts),
                    {"device": dev})
        if entry == "simulate_history":
            return engine.simulate_history, (self.scenario(),), {"device": dev}
        if entry == "batch":
            return engine.simulate, (self.batch_scenario(),), {"device": dev}
        if entry == "campaign_sharded":
            return (campaign.run_campaign, (self.batch_scenario(),),
                    {"mesh": self.mesh(), "axis": "data", "device": dev})
        raise KeyError(f"no driver for entry {entry!r}")

    def run(self, entry: str) -> RunRecord:
        """The recorded run of an engine entry point."""
        def build():
            fn, args, kw = self.entry_call(entry)
            return record_run(fn, *args, **kw)[1]
        return self.cached(("run", entry), build)

    def run_of(self, label: str, fn: Callable, *args, **kw) -> RunRecord:
        return self.cached(("run", label),
                           lambda: record_run(fn, *args, **kw)[1])


# ---------------------------------------------------------------------------
# pure checkers (the testable cores)
# ---------------------------------------------------------------------------

def _ops_excerpt(ops, n: int = 6) -> str:
    return "; ".join(f"{op.op}{list(op.shapes)}" for op in ops[:n])


def check_phase_skips(steps: list, phases: Iterable[str], entry: str,
                      rule_id: str = "R1") -> list[Finding]:
    """In every batch step each gated phase is entered exactly when its gate
    read True, a skipped phase enqueues no operator, and every host read of
    the step is a gate counted in ``host_any.syncs``."""
    phases = tuple(phases)
    findings = []

    def err(i, msg, ev=""):
        findings.append(_finding(rule_id, "error", entry,
                                 f"batch step {i}: {msg}", ev))

    if not steps:
        return [_finding(rule_id, "error", entry,
                         "no batch step was recorded: the driver did not "
                         "reach step.batch_event_step")]
    for i, rec in enumerate(steps):
        if rec.host_reads != rec.syncs:
            err(i, f"{rec.host_reads} host read(s) but host_any.syncs moved "
                f"by {rec.syncs}: a gate read the host without host_any (or "
                "a phase read it besides its gate)")
        if len(rec.gates) != len(phases):
            err(i, f"{len(rec.gates)} gate(s), expected one host_any per "
                f"gated phase {phases}", f"gates {rec.gates}")
            continue
        for phase, gate in zip(phases, rec.gates):
            went = phase in rec.entered
            if gate and not went:
                err(i, f"gate of {phase!r} read True but the phase was not "
                    "entered")
            elif went and not gate:
                err(i, f"phase {phase!r} ran though its gate read False: "
                    "the skip is not real (both branches run at every "
                    "event)", f"{rec.phase_ops.get(phase, 0)} operators")
            elif not went and rec.phase_ops.get(phase, 0):
                err(i, f"skipped phase {phase!r} enqueued "
                    f"{rec.phase_ops[phase]} operator(s)")
    return findings


def check_chunk_lifetimes(records: list, entry: str,
                          rule_id: str = "R2") -> list[Finding]:
    """No leaf of a finished chunk (scenario, final state, result) may still
    be referenced when the next chunk starts or the campaign returns:
    ``records`` holds ``(when, alive leaf names)`` per chunk boundary."""
    if not records:
        return [_finding(rule_id, "error", entry,
                         "no chunk boundary was recorded: the campaign did "
                         "not run in chunks")]
    findings = []
    for when, alive in records:
        if alive:
            findings.append(_finding(
                rule_id, "error", entry,
                f"{len(alive)} tensor(s) of the previous chunk are still "
                f"referenced {when}: a chunk outlives its fold and a "
                "streamed campaign pays for every chunk at once",
                ", ".join(alive[:12])))
    return findings


def check_chunk_memory(peaks: dict, entry: str, tol: int = 1 << 20,
                       rule_id: str = "R2") -> list[Finding]:
    """Peak device memory above the held baseline must not grow with the
    number of chunks: ``peaks`` maps chunk counts to bytes."""
    lo, hi = min(peaks), max(peaks)
    if peaks[hi] - peaks[lo] > tol:
        return [_finding(
            rule_id, "error", entry,
            f"peak memory above the baseline grew from {peaks[lo]} bytes "
            f"({lo} chunks) to {peaks[hi]} ({hi} chunks), more than {tol}: "
            "chunks are held past their fold")]
    return []


def check_host_reads(host_reads: int, syncs: int, entry: str,
                     rule_id: str = "R3") -> list[Finding]:
    """A driver reads the host only through ``host_any``: every host read
    it made is one that ``host_any.syncs`` counted."""
    if host_reads != syncs:
        return [_finding(
            rule_id, "error", entry,
            f"{host_reads} host read(s) but host_any counted {syncs}: the "
            "driver reads a value on the host outside its counted gates")]
    return []


def check_hook(label: str, ops: list, written: list,
               sync_error: str | None = None,
               rule_id: str = "R3") -> list[Finding]:
    """An instrument hook is a pure observer: no host read among its
    operators, no input leaf written (``written``: the names whose
    ``_version`` moved) and, on the card, no synchronisation."""
    findings = []
    reads = [op for op in ops if op.host_read]
    if reads:
        findings.append(_finding(
            rule_id, "error", label,
            f"{len(reads)} host read(s) in the hook: an observer must not "
            "wait for the device", _ops_excerpt(reads)))
    if written:
        findings.append(_finding(
            rule_id, "error", label,
            f"the hook wrote into {len(written)} tensor(s) it was given: an "
            "observer must leave its inputs as they were",
            ", ".join(written[:12])))
    if sync_error:
        findings.append(_finding(
            rule_id, "error", label,
            "the hook synchronised with the card "
            "(set_sync_debug_mode('error') raised)", sync_error))
    return findings


def check_shape_stability(ops: list, entry: str,
                          rule_id: str = "R4") -> list[Finding]:
    """No recorded operator may have an output shape that depends on the
    data: each would fork the operator program per trajectory and hide a
    synchronisation."""
    findings = []
    seen = set()
    for op in ops:
        if op.dynamic and (op.op, op.dynamic) not in seen:
            seen.add((op.op, op.dynamic))
            findings.append(_finding(
                rule_id, "error", entry,
                f"data-dependent shape: {op.dynamic} ({op.op})",
                f"{op.op}{list(op.shapes)} {list(op.dtypes)}"))
    return findings


def check_state_shapes(init_shapes: dict, steps: list, entry: str,
                       rule_id: str = "R4") -> list[Finding]:
    """Every ``SimState`` leaf keeps its initial shape after every step."""
    for i, rec in enumerate(steps):
        for name, shape in init_shapes.items():
            got = rec.state_shapes.get(name)
            if got != shape:
                return [_finding(
                    rule_id, "error", entry,
                    f"state leaf {name} changed shape at batch step {i}: "
                    f"{shape} -> {got}")]
    return []


def check_rank_consistency(single_shapes: dict, batch_shapes: dict,
                           batch: int, entry: str,
                           rule_id: str = "R4") -> list[Finding]:
    """Each batch-path SimState leaf must be exactly ``[B] + single`` — the
    contract that lets ``_freeze`` broadcast its row mask per leaf."""
    findings = []
    for path, s_shape in single_shapes.items():
        b_shape = batch_shapes.get(path)
        if b_shape is None:
            findings.append(_finding(
                rule_id, "error", entry,
                f"state leaf {path} exists on the single path only",
            ))
        elif tuple(b_shape) != (batch,) + tuple(s_shape):
            findings.append(_finding(
                rule_id, "error", entry,
                f"state leaf {path}: batch shape {tuple(b_shape)} != "
                f"({batch},) + single shape {tuple(s_shape)}",
            ))
    for path in batch_shapes:
        if path not in single_shapes:
            findings.append(_finding(
                rule_id, "error", entry,
                f"state leaf {path} exists on the batch path only",
            ))
    return findings


def _first_difference(a: tuple, b: tuple) -> str:
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return f"operator {i}: {x} vs {y}"
    return f"lengths {len(a)} vs {len(b)} (the first {min(len(a), len(b))} " \
           "agree)"


def check_one_program(steps: list, entry: str,
                      rule_id: str = "R5") -> list[Finding]:
    """Batch steps with equal gate outcomes must enqueue one ``(op, shapes,
    dtypes)`` sequence, whatever the knob values: ``steps`` holds ``(run
    label, StepRecord)`` pairs from runs of same-shape subjects."""
    groups: dict = {}
    for label, rec in steps:
        groups.setdefault(rec.key(), []).append((label, rec))
    findings = []
    compared = 0
    for key, members in groups.items():
        if len({label for label, _ in members}) > 1:
            compared += 1
        label0, first = members[0]
        sig0 = first.signature()
        for label, rec in members[1:]:
            sig = rec.signature()
            if sig != sig0:
                findings.append(_finding(
                    rule_id, "error", entry,
                    f"steps with gates {key} enqueue different operator "
                    f"sequences in {label0!r} ({len(sig0)} ops) and "
                    f"{label!r} ({len(sig)} ops): a knob became a Python "
                    "branch (one program across knob values broken; a CUDA "
                    "graph of the step could not be replayed)",
                    _first_difference(sig0, sig)))
                break
    if not compared:
        findings.append(_finding(
            rule_id, "info", entry,
            "no gate outcome occurred in more than one run: nothing "
            "compared"))
    return findings


def check_library_loads(misses: dict, entry: str,
                        rule_id: str = "R5") -> list[Finding]:
    """Each kernel library is built and loaded at most once per process:
    ``misses`` maps a loader to its ``functools.cache`` misses."""
    return [_finding(rule_id, "error", entry,
                     f"kernel library {name} was loaded {n} times: a re-plan "
                     "rebuilt or reloaded it")
            for name, n in misses.items() if n > 1]


def check_fold_traces(folds: list, entry: str,
                      rule_id: str = "R5") -> list[Finding]:
    """Every fold of equal chunk shape enqueues one operator sequence:
    ``folds`` holds ``(chunk rows, signature)`` per fold call, over the
    rungs of two successive-halving runs."""
    if not folds:
        return [_finding(rule_id, "error", entry, "no fold was recorded")]
    first: dict = {}
    for rows, sig in folds:
        if rows not in first:
            first[rows] = sig
        elif sig != first[rows]:
            return [_finding(
                rule_id, "error", entry,
                f"two folds of {rows}-row chunks enqueue different operator "
                "sequences: a rung's population or a knob value changed the "
                "fold program", _first_difference(first[rows], sig))]
    return []


# Hopper's limits (H100 SXM), independent of the kernel modules' own
# constants so that a doctored constant cannot hide a violation
MAX_THREADS = 1024
WARP = 32
WARPGROUP = 128
MAX_DYN_SMEM = 232_448
MAX_GRID_X = 2**31 - 1
MAX_GRID_YZ = 65_535


def _check_grid(what: str, grid: tuple, entry: str,
                rule_id: str) -> list[Finding]:
    grid = tuple(grid) + (1,) * (3 - len(grid))
    out = []
    if not 0 < grid[0] <= MAX_GRID_X:
        out.append(_finding(rule_id, "error", entry,
                            f"{what}: grid.x {grid[0]} outside "
                            f"1..{MAX_GRID_X}"))
    for axis, n in zip("yz", grid[1:]):
        if not 0 < n <= MAX_GRID_YZ:
            out.append(_finding(rule_id, "error", entry,
                                f"{what}: grid.{axis} {n} outside "
                                f"1..{MAX_GRID_YZ}"))
    return out


def _check_block(what: str, threads: int, smem: int, grid: tuple,
                 wgmma: bool, entry: str, rule_id: str,
                 max_threads: int = MAX_THREADS) -> list[Finding]:
    out = []

    def err(msg):
        out.append(_finding(rule_id, "error", entry, f"{what}: {msg}"))

    if not 0 < threads <= max_threads:
        err(f"{threads} threads a block, limit {max_threads}")
    if threads % WARP:
        err(f"{threads} threads are not whole warps of {WARP}")
    if wgmma and threads % WARPGROUP:
        err(f"{threads} threads are not whole warpgroups of {WARPGROUP} (a "
            "wgmma kernel)")
    if not 0 <= smem <= MAX_DYN_SMEM:
        err(f"{smem} bytes of dynamic shared memory, limit {MAX_DYN_SMEM}")
    return out + _check_grid(what, grid, entry, rule_id)


def check_sweep_plan(plan: dict, b: int, c: int, entry: str,
                     fused_cap: int, split_tile: int, n_sm: int,
                     launch_bound: int,
                     rule_id: str = "R6") -> list[Finding]:
    """The advance sweep's plan: a block inside Hopper's limits and its
    ``__launch_bounds__``, the row covered, and fused iff the row fits
    ``fused_cap`` and is not a long row over fewer rows than SMs."""
    what = f"advance sweep [{b}, {c}]"
    out = _check_block(what, plan["threads"], 0, plan["grid"], False, entry,
                       rule_id, max_threads=launch_bound)
    want_fused = c <= fused_cap and not (b < n_sm and c > 4 * split_tile)
    fused = plan["variant"] == "fused"
    if fused != want_fused:
        out.append(_finding(
            rule_id, "error", entry,
            f"{what}: variant {plan['variant']!r}, but the row "
            f"{'fits' if c <= fused_cap else 'exceeds'} FUSED_CAP "
            f"{fused_cap}"))
    covered = plan["threads"] * plan["items"] * plan["nb"]
    if covered < c:
        out.append(_finding(rule_id, "error", entry,
                            f"{what}: the plan covers {covered} of {c} "
                            "elements of a row"))
    # the split grid's y holds at most MAX_GRID_YZ rows; its blocks step
    # through the rest
    rows = plan["grid"][0] if fused else plan["grid"][1]
    if rows != (b if fused else min(b, MAX_GRID_YZ)):
        out.append(_finding(rule_id, "error", entry,
                            f"{what}: the grid holds {rows} rows, not {b}"))
    return out


def check_flash_plan(plan: dict, shape: tuple, entry: str,
                     rule_id: str = "R6") -> list[Finding]:
    """A flash forward plan for ``(b, hq, hk, sq, sk, d)``: its block inside
    Hopper's limits and its grid covering every query row of every column
    slice (x) of every (batch, head) pair (y and z, folded past
    MAX_GRID_YZ, times the plan's ``pair_chunks`` launches)."""
    b, hq, _, sq, _, _ = shape
    what = f"flash forward {shape} {plan['variant']}"
    out = _check_block(what, plan["threads"], plan["smem"], plan["grid"],
                       plan["variant"].startswith("wgmma"), entry, rule_id)
    gx, gy, gz = plan["grid"]
    if (gx * plan["block_q"] < sq * plan["slices"]
            or gy * gz * plan["pair_chunks"] < hq * b):
        out.append(_finding(rule_id, "error", entry,
                            f"{what}: grid {plan['grid']} does not cover "
                            f"{sq} rows x {hq} heads x {b}"))
    return out


def check_flash_bwd_plan(plan: dict, shape: tuple, entry: str,
                         rule_id: str = "R6") -> list[Finding]:
    """A flash backward plan: the dK/dV and dQ blocks inside Hopper's
    limits, and the grids of its three launches (times ``pair_chunks``)."""
    b, hq, hk, sq, sk, _ = shape
    wgmma = plan["variant"].startswith("wgmma")
    out = []
    for kernel, rows, heads in (("dkdv", sk, hk), ("dq", sq, hq)):
        k = plan[kernel]
        grid = plan["grids"][kernel]
        what = f"flash backward {kernel} {shape} {plan['variant']}"
        out += _check_block(what, k["threads"], k["smem"], grid, wgmma,
                            entry, rule_id)
        if (grid[0] * k["rows"] < rows * plan["slices"]
                or grid[1] * grid[2] * plan["pair_chunks"] < heads * b):
            out.append(_finding(rule_id, "error", entry,
                                f"{what}: grid {grid} does not cover {rows} "
                                f"rows x {heads} heads x {b}"))
    for launch in ("delta", "combine"):   # combine: the native dK/dV shares
        if launch in plan["grids"]:
            out += _check_grid(f"flash backward {launch} {shape}",
                               plan["grids"][launch], entry, rule_id)
    return out


def check_ssd_plan(plan: dict, shape: tuple, entry: str,
                   rule_id: str = "R6") -> list[Finding]:
    """An SSD scan plan: every phase's block inside Hopper's limits (whole
    warpgroups for a phase with wgmma shapes)."""
    out = []
    for ph in plan["phases"]:
        out += _check_block(f"ssd {ph['name']} {shape}", ph["threads"],
                            ph["smem"], ph["grid"], bool(ph["mma"]), entry,
                            rule_id)
    return out


def check_geometry(what: str, planned, built, entry: str,
                   rule_id: str = "R6") -> list[Finding]:
    """What a plan reports without the library equals what the built
    library launches with."""
    if built is None:
        return [_finding(rule_id, "error", entry,
                         f"{what}: the built library has no instantiation")]
    if tuple(planned) != tuple(built):
        return [_finding(rule_id, "error", entry,
                         f"{what}: the plan says {tuple(planned)}, the built "
                         f"library {tuple(built)}")]
    return []


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------

_R1_ENTRIES = ("simulate", "batch", "campaign_sharded")


@rule("R1", "cond-not-select", entries=_R1_ENTRIES)
def _rule_cond_not_select(ctx: LintContext) -> list[Finding]:
    """Phase skips are real: a phase runs exactly when its counted gate reads True."""
    findings = []
    phases = tuple(label for label, _ in PHASES)
    for entry in _R1_ENTRIES:
        if ctx.wants(entry):
            findings += check_phase_skips(ctx.run(entry).steps, phases, entry)
    return findings


def _named_leaves(tree, prefix: str) -> list[tuple[str, Tensor]]:
    """``(path, leaf)`` of a tensor tree (a dataclass of tensors, tuples of
    them, or a tensor)."""
    if isinstance(tree, Tensor):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree):
        out = []
        for f in dataclasses.fields(tree):
            out += _named_leaves(getattr(tree, f.name), f"{prefix}.{f.name}")
        return out
    if isinstance(tree, (tuple, list)):
        out = []
        for i, x in enumerate(tree):
            out += _named_leaves(x, f"{prefix}[{i}]")
        return out
    return []


def probe_chunk_lifetimes(batched, chunk_size: int, reduce, device,
                          mesh=None) -> list:
    """``run_campaign(batched, chunk_size=, reduce=)`` with weak references
    to every chunk's scenario, final state and result leaves; returns
    ``(when, alive leaf names of the previous chunk)`` at each chunk's start
    and after the campaign.  The collector is off meanwhile, so a leaf kept
    by a reference cycle counts as alive, as it would on the card until a
    collection."""
    from repro_torch.core import campaign, engine

    held: list[tuple[str, weakref.ref]] = []
    records = []

    def alive() -> list[str]:
        return [name for name, ref in held if ref() is not None]

    def simulate_wrapper(orig):
        def _simulate(chunk, dev, mesh_, axis):
            if held:
                records.append((f"when chunk {len(records) + 1} starts",
                                alive()))
                held.clear()
            held.extend((n, weakref.ref(t))
                        for n, t in _named_leaves(chunk, "scenario"))
            res = orig(chunk, dev, mesh_, axis)
            held.extend((n, weakref.ref(t))
                        for n, t in _named_leaves(res, "result"))
            return res
        return _simulate

    def finalize_wrapper(orig):
        def finalize_result(scn, st):
            held.extend((n, weakref.ref(t))
                        for n, t in _named_leaves(st, "state"))
            return orig(scn, st)
        return finalize_result

    was_enabled = gc.isenabled()
    gc.disable()
    try:
        with wrapped(campaign, "_simulate", simulate_wrapper), \
                wrapped(engine, "finalize_result", finalize_wrapper):
            out = campaign.run_campaign(batched, chunk_size=chunk_size,
                                        reduce=reduce, device=device,
                                        mesh=mesh, axis="data")
        records.append(("after the campaign returned", alive()))
        del out
    finally:
        if was_enabled:
            gc.enable()
    return records


def _r2_reducers(n: int) -> dict:
    from repro_torch.core import reducers
    return {"mean": reducers.MeanReducer("mean_turnaround"),
            "values": reducers.ValuesReducer("makespan", n_slots=n),
            "best": reducers.ArgBestReducer("mean_turnaround")}


def _r2_campaign(ctx: LintContext, rows: int):
    """Fig. 9/10 at 300 hosts (a chunk of 64 rows holds ~2.5 MB, so a
    chunk kept past its fold shows in the peak), held on the host."""
    from repro_torch.core import campaign, scenarios
    from repro_torch.core.entities import SPACE_SHARED
    one = scenarios.fig9_10_scenario(SPACE_SHARED, n_hosts=300, n_groups=3,
                                     device="cpu")
    return campaign.broadcast_campaign(one, rows)


# chunk rows of the R2 probes: on the card enough for a kept chunk to move
# the peak by megabytes; on the CPU (no allocator statistics) a few rows
R2_CHUNK = {"cuda": 64, "cpu": 2}
R2_CHUNKS = (2, 8)


def probe_chunk_memory(ctx: LintContext, chunk: int) -> dict:
    """Peak device memory above the held baseline of ``run_campaign`` over
    2 and 8 chunks of ``chunk`` rows (the campaign held on the host)."""
    from repro_torch.core import campaign
    peaks = {}
    for n in R2_CHUNKS:
        batched = _r2_campaign(ctx, n * chunk)
        torch.cuda.synchronize(ctx.device)
        gc.collect()
        base = torch.cuda.memory_allocated(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
        out = campaign.run_campaign(batched, chunk_size=chunk,
                                    reduce=_r2_reducers(n * chunk),
                                    device=ctx.device)
        torch.cuda.synchronize(ctx.device)
        peaks[n] = torch.cuda.max_memory_allocated(ctx.device) - base
        del out
    return peaks


@rule("R2", "donation-aliases", entries=("campaign_chunk", "campaign_sharded"))
def _rule_donation_aliases(ctx: LintContext) -> list[Finding]:
    """Chunks do not outlive their fold: streamed memory stays one chunk's."""
    findings = []
    chunk = R2_CHUNK[ctx.device.type]
    rows = R2_CHUNKS[-1] * chunk
    for entry in ("campaign_chunk", "campaign_sharded"):
        if not ctx.wants(entry):
            continue
        mesh = ctx.mesh() if entry == "campaign_sharded" else None
        records = ctx.cached(("r2", entry), lambda: probe_chunk_lifetimes(
            _r2_campaign(ctx, rows), chunk, _r2_reducers(rows), ctx.device,
            mesh=mesh))
        findings += check_chunk_lifetimes(records, entry)
    if ctx.on_card and ctx.wants("campaign_chunk"):
        peaks = ctx.cached("r2_peaks", lambda: probe_chunk_memory(ctx, chunk))
        findings += check_chunk_memory(peaks, "campaign_chunk")
    return findings


def _hook_subjects(ctx: LintContext):
    """``(label, scenario, extra instruments)`` whose instruments R3 reads:
    Fig. 4 with the trace and utilisation observers the drivers attach,
    and the scenarios that attach the autoscale, migration and reliability
    instruments."""
    from repro_torch.core import scenarios, step
    dev = ctx.device
    ts = torch.linspace(0.0, 400.0, _TRACE_SAMPLES, device=dev)
    extras = (step.TraceInstrument(sample_ts=ts),
              step.UtilizationTimelineInstrument(sample_ts=ts))
    gen = torch.Generator().manual_seed(0)
    return (
        ("fig4", ctx.scenario(), extras),
        ("autoscale", scenarios.autoscale_scenario(gen, device=dev), ()),
        ("table1 live migration",
         scenarios.table1_scenario(True, live_migration=True,
                                   migrate_balance_thresh=0.75, device=dev),
         ()),
        ("reliability",
         scenarios.reliability_scenario(gen, evacuation=True, device=dev), ()),
    )


def _versions(named: list) -> dict:
    return {name: t._version for name, t in named}


def probe_hooks(scn, extras: tuple, on_card: bool) -> list:
    """Each hook of each instrument ``step.instruments_for(scn, extras)``
    attaches, called on the state and event of the scenario's first batch
    step: ``(label, ops, written leaf names, sync error)`` per hook."""
    from repro_torch.core import engine, step

    scn_b, _ = engine._as_batch(scn, scn.hosts.cores.device)
    ctx, aux = step.make_context(scn_b, extras)
    st = engine.init_state(scn_b)
    live = step.step_cond(scn_b, st, step.resolve_max_steps(
        scn_b, ctx.instruments))
    (st1, aux1), ev, _ = step.batch_event_step(scn_b, (st, aux), ctx, live)
    out = []
    for i, ins in enumerate(ctx.instruments):
        hooks = {
            "pre": lambda ins=ins, a=aux1[i]: ins.pre(scn_b, st1, a),
            "bound": lambda ins=ins, a=aux1[i]: ins.bound(scn_b, st1, a),
            "post": lambda ins=ins, a=aux1[i]: ins.post(scn_b, st1, ev, a),
            "finalize": lambda ins=ins, a=aux1[i]: ins.finalize(scn_b, st1, a),
        }
        inputs = (_named_leaves(scn_b, "scn") + _named_leaves(st1, "st")
                  + _named_leaves(aux1[i], "aux") + _named_leaves(ev, "ev")
                  + (_named_leaves(ins, "instrument")
                     if dataclasses.is_dataclass(ins) else []))
        for hook, fn in hooks.items():
            before = _versions(inputs)
            rec = OpRecorder()
            sync_error = None
            with rec:
                if on_card:
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                    try:
                        fn()
                    except RuntimeError as e:
                        sync_error = str(e).splitlines()[0]
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                else:
                    fn()
            after = _versions(inputs)
            written = sorted({n for n in before if after[n] != before[n]})
            out.append((f"instrument:{ins.name}.{hook}", rec.ops, written,
                        sync_error))
    return out


_R3_ENTRIES = ("simulate", "simulate_trace", "simulate_history", "batch",
               "campaign_sharded")


@rule("R3", "pure-observer", entries=_R3_ENTRIES)
def _rule_pure_observer(ctx: LintContext) -> list[Finding]:
    """Drivers read the host only through host_any; hooks neither read it nor write inputs."""
    findings = []
    for entry in _R3_ENTRIES:
        if ctx.wants(entry):
            run = ctx.run(entry)
            findings += check_host_reads(run.host_reads, run.syncs, entry)
    if ctx.wants("simulate"):
        for name, scn, extras in ctx.cached("hook_subjects",
                                            lambda: _hook_subjects(ctx)):
            hooks = ctx.cached(("hooks", name), lambda: probe_hooks(
                scn, extras, ctx.on_card))
            for label, ops, written, sync_error in hooks:
                # the default instruments run in every subject: report
                # each (hook, fault) once
                findings += [f for f in check_hook(label, ops, written,
                                                   sync_error)
                             if (f.entry_point, f.message) not in
                             {(g.entry_point, g.message) for g in findings}]
    return findings


def _advance_ops(ctx: LintContext) -> list:
    """The operators of one advance sweep on a ``[4, 96]`` block, through
    the routing the engine uses (``ops.resolve_advance``)."""
    from repro_torch.kernels import ops
    dev = ctx.device
    b, c = _BATCH, 96
    args = (torch.ones(b, c, device=dev), torch.ones(b, c, device=dev),
            torch.ones(b, c, dtype=torch.bool, device=dev),
            torch.full((b,), 10.0, device=dev))
    rec = OpRecorder()
    with rec:
        ops.resolve_advance(dev)(*args)
    return rec.ops


@rule("R4", "shape-stable-scan",
      entries=("simulate", "batch", "campaign_sharded", "advance"))
def _rule_shape_stable(ctx: LintContext) -> list[Finding]:
    """No data-dependent shapes in a step; SimState shapes stable and rank-consistent."""
    from repro_torch.core import engine
    findings = []
    for entry in ("simulate", "batch", "campaign_sharded"):
        if not ctx.wants(entry):
            continue
        run = ctx.run(entry)
        findings += check_shape_stability(
            [op for rec in run.steps for op in rec.ops], entry)
        if run.steps:
            scn = ctx.batch_scenario() if entry != "simulate" \
                else ctx.scenario()
            init = _state_shapes(engine.init_state(
                engine._as_batch(scn, ctx.device)[0]))
            findings += check_state_shapes(init, run.steps, entry)
    if ctx.wants("advance"):
        findings += check_shape_stability(
            ctx.cached("advance_ops", lambda: _advance_ops(ctx)), "advance")
    if ctx.wants("batch"):
        one = _state_shapes(engine.init_state(
            engine._as_batch(ctx.scenario(), ctx.device)[0]))
        four = _state_shapes(engine.init_state(ctx.batch_scenario()))
        single = {}
        for path, shape in one.items():
            if not shape or shape[0] != 1:
                findings.append(_finding(
                    "R4", "error", "batch",
                    f"state leaf {path} of one scenario has shape {shape}, "
                    "not [1, ...]"))
            single[path] = shape[1:]
        findings += check_rank_consistency(single, four, _BATCH, "batch")
    return findings


# the search probe: the reference's space, population and rungs
_SEARCH_SPACE = {"sensor_interval": (1.0, 2.0, 4.0),
                 "ckpt_interval": (50.0, 100.0)}
_SEARCH = dict(n0=4, fidelities=(100.0, 400.0), chunk_size=2,
               metric="mean_turnaround")


def _library_loaders() -> dict:
    from repro_torch.kernels import flash_attention, ssd_scan, vm_update
    return {"vm_update": vm_update._library,
            "flash_attention": flash_attention._library,
            "flash_attention_bwd": flash_attention._bwd_library,
            "ssd_scan": ssd_scan._library}


def probe_search(ctx: LintContext) -> tuple[dict, list]:
    """Two successive-halving runs (generators seeded 0 and 7): each kernel
    library's loads after them, and ``(chunk rows, signature)`` of every
    fold they made."""
    from repro_torch.core import reducers, search
    folds = []

    def fold_wrapper(orig):
        def fold(self, carry, chunk, res, index, valid):
            rec = OpRecorder()
            with rec:
                out = orig(self, carry, chunk, res, index, valid)
            folds.append((int(index.shape[0]),
                          tuple(op.signature() for op in rec.ops)))
            return out
        return fold

    with wrapped(reducers.ValuesReducer, "fold", fold_wrapper):
        for seed in (0, 7):
            search.successive_halving(
                ctx.scenario(), _SEARCH_SPACE,
                generator=torch.Generator().manual_seed(seed),
                device=ctx.device, **_SEARCH)
    misses = {name: fn.cache_info().misses
              for name, fn in _library_loaders().items()}
    return misses, folds


@rule("R5", "recompile-hazard", entries=("simulate", "batch", "campaign_chunk"))
def _rule_recompile_hazard(ctx: LintContext) -> list[Finding]:
    """One operator program across knob values; kernel libraries load once."""
    from repro_torch.core import campaign, engine
    findings = []
    if ctx.wants("simulate"):
        a = ctx.run("simulate")
        b = ctx.run_of("simulate:variant", engine.simulate,
                       ctx.scenario_variant(), device=ctx.device)
        findings += check_one_program(
            [("fig4", s) for s in a.steps]
            + [("fig4 time-shared variant", s) for s in b.steps], "simulate")
    if ctx.wants("batch"):
        a = ctx.run("batch")
        b = ctx.run_of("batch:variant", engine.simulate,
                       campaign.broadcast_campaign(ctx.scenario_variant(),
                                                   _BATCH),
                       device=ctx.device)
        findings += check_one_program(
            [("4-row batch", s) for s in a.steps]
            + [("broadcast variant", s) for s in b.steps], "batch")
    if ctx.wants("campaign_chunk"):
        misses, folds = ctx.cached("search", lambda: probe_search(ctx))
        findings += check_library_loads(misses, "campaign_chunk")
        findings += check_fold_traces(folds, "campaign_chunk")
    return findings


# R6 shapes: the shapes PERF.md section 6 and chip_smoke.py run each kernel
# at, then the edges of each plan
_SWEEP_SHAPES = ((1024, 500), (512, 500), (1024, 48), (1, 500), (1, 131072),
                 (1, 3 * 2**17), (8192, 4096))
_FLASH_SHAPES = (
    (1, 16, 8, 512, 512, 128), (1, 16, 8, 8192, 8192, 128),
    (1, 32, 16, 8192, 8192, 128), (2, 32, 32, 1024, 1024, 96),
    (2, 4, 2, 300, 300, 64), (1, 16, 8, 128, 1000, 128),
    (1, 16, 8, 512, 512, 64), (1, 32, 8, 512, 512, 128),
    (2, 20, 20, 1500, 1500, 64), (2, 20, 20, 1, 1500, 64),
    (1, 64, 8, 1280, 1280, 128), (8, 16, 8, 2048, 2048, 128),
    (1, 32, 16, 4096, 4096, 128), (1, 32, 32, 1024, 1024, 96),
    (4, 16, 8, 2048, 2048, 64), (2, 20, 20, 64, 1500, 64),
    (2, 20, 20, 64, 64, 64), (1, 16, 16, 128, 1000, 128),
    (1, 8, 8, 256, 128, 64),
)
_SSD_SHAPES = ((8, 2048, 24, 64, 1, 128), (2, 300, 8, 32, 2, 64),
               (1, 4096, 128, 64, 1, 16))


def _sweep_cases(n_sm: int, fused_cap: int, split_tile: int) -> list:
    """The sweep's shapes and the edges of its plan: rows around the SM
    count and the split grid's limit, row lengths around the fused cap and
    the long-row split."""
    cs = (1, 31, 32, 33, fused_cap, fused_cap + 1, 4 * split_tile,
          4 * split_tile + 1, 1 << 20)
    bs = (1, n_sm - 1, n_sm, MAX_GRID_YZ, 70_000)
    return list(_SWEEP_SHAPES) + [(b, c) for b in bs for c in cs]


# head widths past the narrow instantiations' (``fa.HEAD_DIMS``): off the
# multiple of 8 (padded) and past 128 (column slices)
WIDE_HEADS = (1, 4, 20, 100, 136, 192, 256, 512, 520)


def _attention_cases(heads: tuple, n_sm: int) -> list:
    """Edges of the flash plans: every head dim, the SM-count boundary of
    the 128-row blocks, the grid's y and z limits and (batch, head) counts
    past them and past one launch's pairs, a grid.x of 2^20 tiles of 64
    rows."""
    out = []
    for d in heads:
        out += [(1, 1, 1, 128 * (n_sm - 1), 128 * (n_sm - 1), d),
                (1, 1, 1, 128 * n_sm, 128 * n_sm, d),
                (1, MAX_GRID_YZ, MAX_GRID_YZ, 64, 64, d),
                (MAX_GRID_YZ, 1, 1, 64, 64, d),
                (1, 70_000, 70_000, 64, 64, d),
                (70_000, 2, 1, 64, 64, d),
                (65_536, 32_768, 1, 1, 1, d),
                (1, 1, 1, 64 << 20, 64, d)]
    return out


def _plans(ctx: LintContext) -> dict:
    """Every audited plan: ``{kernel: [(shape, dtype, plan), ...]}``."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan, vm_update
    bf16, f32 = torch.bfloat16, torch.float32
    out = {"sweep": [], "flash": [], "flash_bwd": [], "ssd": []}
    for b, c in _sweep_cases(vm_update.N_SM, vm_update.FUSED_CAP,
                             vm_update.SPLIT_TILE):
        out["sweep"].append(((b, c), f32, vm_update.kernel_plan(b, c)))
    shapes = list(_FLASH_SHAPES) + _attention_cases(
        fa.HEAD_DIMS + WIDE_HEADS, fa.N_SM)
    for shape in shapes:
        for dtype in (bf16, f32):
            out["flash"].append((shape, dtype,
                                 fa.kernel_plan(*shape, dtype)))
            out["flash_bwd"].append((shape, dtype,
                                     fa.kernel_plan_bwd(*shape, dtype)))
    ssd_cases = list(_SSD_SHAPES) + [
        (1, 256, 2, p, 1, n) for p in ssd_scan.HEAD_DIMS
        for n in ssd_scan.HEAD_DIMS] + [
        (1, 300, MAX_GRID_YZ, 64, 1, 64), (MAX_GRID_YZ, 64, 1, 64, 1, 64),
        (70_000, 8, 2, 16, 1, 16), (1, 8, 70_000, 16, 1, 16),
        (1, 100, 2, 8, 1, 24), (1, 96, 2, 192, 1, 256)]
    for shape in ssd_cases:
        for dtype in (bf16, f32):
            for chunk in (8, 32, 48, 64, 96, 128, 160, 256):
                out["ssd"].append(((*shape, chunk), dtype,
                                   ssd_scan.kernel_plan(*shape, chunk,
                                                        dtype)))
    return out


def probe_geometry(plans: dict, n_sm: int) -> list:
    """``(what, planned, built)`` for every plan against the loaded
    libraries (on the card: this builds and loads them)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan
    out = []
    seen = set()
    for shape, dtype, plan in plans["flash"]:
        key = ("flash", dtype, shape[-1], plan["block_q"])
        if key not in seen:
            seen.add(key)
            out.append((f"flash forward {dtype} D {shape[-1]} "
                        f"{plan['block_q']} rows",
                        (plan["block_k"], plan["threads"], plan["smem"]),
                        fa.kernel_geometry(dtype, shape[-1], plan["block_q"])))
    for shape, dtype, plan in plans["flash_bwd"]:
        b, hq, hk, sq, sk, d = shape
        rows = (plan["dkdv"]["rows"], plan["dq"]["rows"])
        out.append((f"flash backward {dtype} {shape} block rows", rows,
                    fa.kernel_block_rows_bwd(b, hq, hk, sq, sk, d, dtype,
                                             n_sm)))
        for i, kernel in enumerate(("dkdv", "dq")):
            k = plan[kernel]
            key = ("bwd", dtype, d, kernel, k["rows"])
            if key in seen:
                continue
            seen.add(key)
            built = fa.kernel_geometry_bwd(dtype, d, k["rows"])
            out.append((f"flash backward {kernel} {dtype} D {d} "
                        f"{k['rows']} rows",
                        (k["other"], k["threads"], k["smem"]),
                        None if built is None
                        else (built[0], built[1], built[2 + i])))
    for shape, dtype, plan in plans["ssd"]:
        p, n = plan["p_width"], plan["n_width"]     # the widths that run
        key = ("ssd", dtype, p, n, plan["rows"])
        if key in seen:
            continue
        seen.add(key)
        built = ssd_scan.kernel_geometry(dtype, p, n, plan["rows"])
        out.append((f"ssd {dtype} P {p} N {n} {plan['rows']} rows",
                    tuple((ph["threads"], ph["smem"])
                          for ph in plan["phases"]),
                    None if built is None else tuple(built)))
    return out


@rule("R6", "kernel-budget", entries=("advance",))
def _rule_kernel_budget(ctx: LintContext) -> list[Finding]:
    """All four launch plans inside Hopper's limits (and equal to the built libraries on the card)."""
    from repro_torch.kernels import vm_update
    if not ctx.wants("advance"):
        return []
    plans = ctx.cached("plans", lambda: _plans(ctx))
    findings = []
    for (b, c), _, plan in plans["sweep"]:
        findings += check_sweep_plan(
            plan, b, c, "advance", vm_update.FUSED_CAP, vm_update.SPLIT_TILE,
            vm_update.N_SM, vm_update.FUSED_THREADS)
    for shape, _, plan in plans["flash"]:
        findings += check_flash_plan(plan, shape, "advance")
    for shape, _, plan in plans["flash_bwd"]:
        findings += check_flash_bwd_plan(plan, shape, "advance")
    for shape, _, plan in plans["ssd"]:
        findings += check_ssd_plan(plan, shape, "advance")
    if ctx.on_card:
        n_sm = torch.cuda.get_device_properties(
            ctx.device).multi_processor_count
        for what, planned, built in ctx.cached(
                "geometry", lambda: probe_geometry(plans, n_sm)):
            findings += check_geometry(what, planned, built, "advance")
    return findings


# ---------------------------------------------------------------------------
# driver + report
# ---------------------------------------------------------------------------


def run_lint(rules: Iterable[str] | None = None,
             entries: Iterable[str] | None = None, device=None,
             ctx: LintContext | None = None) -> list[Finding]:
    """Run the (filtered) rule registry on ``device`` (``None``: the GPU);
    returns all findings.  Pass ``ctx`` to read its artifacts afterwards
    (the caller closes it)."""
    wanted = tuple(rules) if rules else tuple(RULES)
    unknown = set(wanted) - set(RULES)
    if unknown:
        raise ValueError(
            f"unknown rule(s) {sorted(unknown)}; known: {list(RULES)}"
        )
    own = ctx is None
    ctx = ctx or LintContext(entries, device)
    try:
        findings = []
        with torch.no_grad():
            for rule_id in sorted(wanted):
                findings.extend(RULES[rule_id].fn(ctx))
    finally:
        if own:
            ctx.close()
    order = {s: i for i, s in enumerate(SEVERITIES)}
    findings.sort(key=lambda f: (order.get(f.severity, 99), f.rule))
    return findings


def summarize(findings: list[Finding]) -> dict:
    counts = {s: 0 for s in SEVERITIES}
    for f in findings:
        counts[f.severity] = counts.get(f.severity, 0) + 1
    return counts


def format_report(findings: list[Finding],
                  rules: Iterable[str] | None = None) -> str:
    """Human-readable lint report (the CLI's default output)."""
    lines = []
    checked = sorted(rules) if rules else sorted(RULES)
    for rule_id in checked:
        spec = RULES[rule_id]
        hits = [f for f in findings if f.rule == rule_id]
        status = "ok" if not any(
            f.severity == "error" for f in hits
        ) else "FAIL"
        lines.append(f"[{status:4s}] {rule_id} {spec.name}: {spec.doc}")
        for f in hits:
            lines.append(f"    {f.severity.upper():7s} {f.entry_point}: "
                         f"{f.message}")
            if f.evidence:
                lines.append(f"            | {f.evidence[:160]}")
    counts = summarize(findings)
    lines.append(
        f"simlint: {counts['error']} error(s), {counts['warning']} "
        f"warning(s), {counts['info']} info"
    )
    return "\n".join(lines)


def step_stats(ctx: LintContext) -> dict:
    """Per entry linted by R1: batch steps, operators per step (min, mean,
    max) and ``host_any.syncs`` per step, from the recorded runs."""
    out = {}
    for entry in _R1_ENTRIES:
        run = ctx.get(("run", entry))
        if run is None or not run.steps:
            continue
        n_ops = [len(s.ops) for s in run.steps]
        syncs = [s.syncs for s in run.steps]
        out[entry] = {"steps": len(run.steps), "ops_min": min(n_ops),
                      "ops_mean": sum(n_ops) / len(n_ops),
                      "ops_max": max(n_ops),
                      "syncs_per_step": sum(syncs) / len(syncs),
                      "driver_syncs": run.syncs - sum(syncs)}
    return out
