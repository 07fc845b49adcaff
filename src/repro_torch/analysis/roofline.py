"""Roofline terms of one traced step: the port of ``repro.analysis.roofline``
with the NVIDIA H100's constants in place of the TPU v5e's.

Per (arch x shape x mesh) three times (seconds a step, per rank):

    compute    = dot FLOPs per rank / peak FLOP/s
    memory     = HBM bytes per rank / HBM bandwidth
    collective = effective collective bytes per rank / link bandwidth

The dot FLOPs and the collectives come from ``analysis.trace`` (the step
traced on shape-only tensors over a process group of the mesh's size,
each rank's local operations counted by ``FlopCounterMode`` and
``CommDebugMode``); the HBM bytes from the analytic ``analysis.memory``
model.  The reference's ``collective_stats`` parses HLO text, which torch
has not: ``trace.RankComms.stats()`` fills the same ``CollectiveStats``.

Effective bytes per collective op (ring algorithm, n = group size):
    all-reduce        2 * (n-1)/n * operand
    all-gather        (n-1)/n * result          (operand is the shard)
    reduce-scatter    (n-1)/n * operand
    all-to-all        (n-1)/n * operand
    collective-permute        operand

Hardware constants, spec-sheet figures of an NVIDIA H100 80GB HBM3 (SXM,
700 W), NVIDIA's H100 Tensor Core GPU datasheet:

* ``PEAK_FLOPS`` 989e12: dense bf16 tensor-core FLOP/s (the sheet's 1,979
  TFLOPS bf16 are "with sparsity"; dense is half).
* ``FP32_FLOPS`` 67e12: f32 FLOP/s outside the tensor cores.
* ``HBM_BW`` 3.35e12 B/s: HBM3 bandwidth.
* ``LINK_BW`` 450e9 B/s: NVLink, one direction (900 GB/s both ways), the
  link a collective between the cards of one host crosses.  A mesh that
  spans hosts crosses slower links; this constant charges NVLink's rate,
  as the reference charges one ICI link's.
"""
from __future__ import annotations

import dataclasses

PEAK_FLOPS = 989e12
FP32_FLOPS = 67e12
HBM_BW = 3.35e12
LINK_BW = 450e9


def ring_bytes(kind: str, n: int, operand: float, result: float) -> float:
    """The bytes a collective of ``kind`` over ``n`` ranks moves across
    links per rank, by the ring model above."""
    ring = (n - 1) / max(n, 1)
    if kind == "all-reduce":
        return 2 * ring * operand
    if kind == "all-gather":
        return ring * result
    if kind in ("reduce-scatter", "all-to-all"):
        return ring * operand
    return operand                                  # collective-permute


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    raw_bytes: dict            # summed operand bytes per kind
    effective_bytes: float     # ring-model bytes that cross links, per rank

    def total_raw(self) -> int:
        return sum(self.raw_bytes.values())


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_device: float
    bytes_per_device: float
    collective: CollectiveStats
    model_flops: float          # 6ND (train) / 2ND (inference), whole step
    n_chips: int

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """No-overlap upper bound on achievable step time."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flop_fraction(self) -> float:
        """MODEL_FLOPS / (traced FLOPs summed over ranks)."""
        total = self.flops_per_device * self.n_chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful flops / (ranks * peak * step_time)."""
        denom = self.n_chips * PEAK_FLOPS * self.step_time_s
        return self.model_flops / denom if denom else 0.0

    def as_dict(self) -> dict:
        return {
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_counts": self.collective.counts,
            "collective_raw_bytes": self.collective.raw_bytes,
            "collective_effective_bytes": self.collective.effective_bytes,
            "model_flops": self.model_flops,
            "useful_flop_fraction": self.useful_flop_fraction,
            "roofline_fraction": self.roofline_fraction,
            "step_time_bound_s": self.step_time_s,
            "n_chips": self.n_chips,
        }


def analyze_walk(walk, mem_estimate, n_chips: int,
                 model_flops: float) -> Roofline:
    """Roofline from a traced step (``trace.StepTrace``: ``dot_flops``,
    ``coll_counts``, ``coll_raw``, ``coll_effective``) + the analytic
    memory model."""
    coll = CollectiveStats(
        counts=walk.coll_counts,
        raw_bytes=walk.coll_raw,
        effective_bytes=walk.coll_effective,
    )
    return Roofline(
        compute_s=walk.dot_flops / PEAK_FLOPS,
        memory_s=mem_estimate.traffic_bytes / HBM_BW,
        collective_s=walk.coll_effective / LINK_BW,
        flops_per_device=walk.dot_flops,
        bytes_per_device=mem_estimate.traffic_bytes,
        collective=coll,
        model_flops=model_flops,
        n_chips=n_chips,
    )


def analyze(cost: dict, coll: CollectiveStats, n_chips: int,
            model_flops: float) -> Roofline:
    """Roofline from a cost dict (``"flops"``, ``"bytes accessed"`` per
    rank) and the collectives of one rank."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    return Roofline(
        compute_s=flops / PEAK_FLOPS,
        memory_s=byts / HBM_BW,
        collective_s=coll.effective_bytes / LINK_BW,
        flops_per_device=flops,
        bytes_per_device=byts,
        collective=coll,
        model_flops=model_flops,
        n_chips=n_chips,
    )


def model_flops_for(cfg, shape) -> float:
    """6ND for training, 2ND for inference (N = active params; D = tokens).

    Attention score FLOPs are excluded by convention; the useful-flop ratio
    in the table therefore understates usefulness for long-sequence cells.
    """
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch  # decode: one token per sequence
    return 2.0 * n * tokens
