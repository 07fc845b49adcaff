"""The dry-run chain (``repro_torch.analysis``, ``launch/dryrun.py``)
against the JAX package's, in one process over fake process groups.

* ``memory.estimate`` and ``roofline.model_flops_for`` equal the
  reference's, entry for entry, for every arch and shape on the ``(16,
  16)`` and ``(2, 16, 16)`` meshes (abstract on both sides).
* ``report``'s two tables give the reference's rows for the same records.
* The bottleneck and ring-model logic (the reference's
  ``test_roofline_bottleneck_logic``, with the H100's constants).
* ``trace.StepTrace`` (``FlopCounterMode``, ``CommDebugMode`` and
  ``MemTracker`` on a rank's local operations) counts a rank's own work:
  hand-built products on ``(1, 1)`` and ``(2, 2)`` meshes give hand counts
  (a fully sharded product 1/4 of its global count on ``(2, 2)``), a
  weight gather one all-gather of the ring model's bytes.
* The kernels' ops on meta tensors give the kernels' output shapes and
  their formulas' FLOPs, and launch nothing.
* A traced smoke train step on ``(2, 2)`` against the reference's
  ``hlo_walk.analyze_hlo`` of its compiled step on 4 XLA host devices (a
  subprocess, as ``test_dryrun_smoke.py`` builds one): per-rank dot FLOPs
  within ``HLO_TOL``, once the two sources of difference are counted.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh as JaxAbstractMesh
from repro.analysis import memory as jax_memory
from repro.analysis import report as jax_report
from repro.analysis import roofline as jax_roofline
from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_get_config
from repro.models import ALL_SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro_torch import tree
from repro_torch.analysis import memory, report, roofline
from repro_torch.analysis.trace import StepTrace
from repro_torch.configs import get_config
from repro_torch.dist import AbstractMesh, param_pspec_tree
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ssd
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ALL_SHAPES, build_model
from repro_torch.models.config import ShapeSpec

from torch_ref_guard import revive_reference_inf  # noqa: F401

pytestmark = pytest.mark.tier1

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _jax_mesh(shape, axes):
    try:
        return JaxAbstractMesh(shape, axes)               # jax >= 0.5
    except TypeError:
        return JaxAbstractMesh(tuple(zip(axes, shape)))   # jax 0.4.x


@pytest.fixture
def fake_world():
    """``fake_world(n)``: an in-process fake process group of n ranks,
    destroyed after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def make(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)

    yield make
    if dist.is_initialized():
        dist.destroy_process_group()


# -------------------------------------------------- the analytic models
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape_i", range(len(ALL_SHAPES)))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_memory_model_and_model_flops_equal_the_reference(arch, shape_i,
                                                          mesh_name):
    mshape, axes = MESHES[mesh_name]
    jcfg = jax_get_config(arch, dtype="bfloat16")
    cfg = get_config(arch, dtype="bfloat16")
    jshape, shape = JAX_SHAPES[shape_i], ALL_SHAPES[shape_i]
    assert jshape.name == shape.name
    want = jax_memory.estimate(jax_build_model(jcfg), jcfg, jshape,
                               _jax_mesh(mshape, axes), microbatches=4)
    got = memory.estimate(build_model(cfg), cfg, shape,
                          AbstractMesh(axes, mshape), microbatches=4)
    assert got.as_dict() == want.as_dict()
    assert (roofline.model_flops_for(cfg, shape)
            == jax_roofline.model_flops_for(jcfg, jshape))


# ------------------------------------------- placements at pod scale
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_placements_at_256_ranks_are_the_references(fake_world, arch):
    """At 256 fake ranks on the ``(16, 16)`` mesh, every parameter the
    dry-run places and every AdamW moment ``adamw_init`` makes of it gets
    the ``DTensor`` placements of the reference's ``param_pspec_tree``
    spec for that leaf."""
    import jax
    from repro.dist import param_pspec_tree as jax_param_pspec_tree
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.dist import P, placements
    from repro_torch.train import adamw_init

    fake_world(256)
    mesh = make_host_mesh((16, 16), ("data", "model"))
    jcfg = jax_get_config(arch, dtype="bfloat16")
    jshapes = jax.eval_shape(jax_build_model(jcfg).init,
                             jax.random.PRNGKey(0))
    jspecs = jax_param_pspec_tree(jshapes,
                                  _jax_mesh((16, 16), ("data", "model")))
    pshapes = build_model(get_config(arch, dtype="bfloat16")).param_specs()
    with FakeTensorMode():
        params = dryrun._placed(pshapes, param_pspec_tree(pshapes, mesh),
                                mesh, "meta")
        state = adamw_init(params)
    n = 0
    for path, leaf in tree.leaves_with_path(params):
        spec = jspecs
        for k in path:
            spec = spec[k]
        want = placements(mesh, P(*spec))
        got = [leaf]
        for m in ("mu", "nu"):
            node = state[m]
            for k in path:
                node = node[k]
            got.append(node)
        for t in got:
            assert tuple(t.placements) == want, (path, t.placements, spec)
        n += 1
    assert n == len(jax.tree.leaves(jshapes))


# ------------------------------------ the kernels' placements on a mesh
def _fake_qkv(mesh, q_spec, kv_spec, hq=16, hk=8, b=16, s=64, d=128):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.api import ShapeDtype

    mode = FakeTensorMode()
    with mode:
        q = dryrun._placed({"x": ShapeDtype((b, hq, s, d), torch.bfloat16)},
                           {"x": q_spec}, mesh, "meta")["x"]
        k, v = (dryrun._placed(
            {"x": ShapeDtype((b, hk, s, d), torch.bfloat16)},
            {"x": kv_spec}, mesh, "meta")["x"] for _ in range(2))
    return mode, q, k, v


def test_flash_takes_the_references_kv_placement(fake_world):
    """internlm2's 16 query and 8 kv heads on a 16-wide model axis: the
    reference's rules (``resolve_dim``) leave the kv heads whole over it,
    and the kernel runs on each rank's block of query heads from them."""
    from repro_torch.dist import P
    from repro_torch.dist.sharding import resolve_dim

    fake_world(256)
    mesh = make_host_mesh((16, 16), ("data", "model"))
    assert resolve_dim(8, ("model",), {"data": 16, "model": 16}, set()) \
        is None
    mode, q, k, v = _fake_qkv(mesh, P("data", "model", None, None),
                              P("data", None, None, None))
    before = ops.local_map_blocks["flash_attention"]
    with mode:
        out = ops.flash_attention(q, k, v, causal=True)
    assert tuple(out.placements) == tuple(q.placements)
    assert out.shape == q.shape
    assert ops.local_map_blocks["flash_attention"] == before + 1


@pytest.mark.parametrize("q_spec,kv_spec,match", [
    # the sequence split: the kernel needs whole rows
    (("data", None, "model", None), ("data", None, "model", None),
     "cannot run locally"),
    # k/v heads that divide the split but are laid out otherwise than q
    (("data", "model", None, None), ("data", None, None, None),
     "neither gathered"),
])
def test_flash_refuses_a_placement_it_cannot_take(fake_world, q_spec,
                                                  kv_spec, match):
    from repro_torch.dist import P

    fake_world(4)
    mesh = make_host_mesh((2, 2), ("data", "model"))
    mode, q, k, v = _fake_qkv(mesh, P(*q_spec), P(*kv_spec), hq=4, hk=2,
                              b=4, s=64, d=64)
    with mode, pytest.raises(ValueError, match=match):
        ops.flash_attention(q, k, v, causal=True)


# ----------------------------------------------------------- the tables
def _record(arch, shape, mesh, i):
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "compile_s": 12.0 + i,
        "params": 1.8e9 + i, "memory_model": {"residency_bytes": 3.5e10 + i},
        "roofline": {
            "compute_s": 0.25 * (i + 1), "memory_s": 1.5e-3 * (i + 1),
            "collective_s": 2.0 / (i + 1), "bottleneck": "collective",
            "useful_flop_fraction": 0.75, "roofline_fraction": 0.031 * i,
            "flops_per_device": 6.0e13 * (i + 1),
            "collective_effective_bytes": 9.4e10,
            "collective_counts": {"all-gather": 1802 + i, "all-reduce": 926},
        },
    }


def test_report_tables_give_the_reference_rows():
    cells = [_record("internlm2-1.8b", "train_4k", "single", 0),
             _record("qwen3-32b", "prefill_32k", "single", 1),
             _record("mamba2-130m", "decode_32k", "multi", 2),
             {"arch": "phi3-mini-3.8b", "shape": "long_500k",
              "mesh": "single", "skipped": "full quadratic attention: 500k "
              "decode needs sub-quadratic mixing"},
             {"arch": "gemma2-27b", "shape": "train_4k", "mesh": "single",
              "error": "Traceback ..."}]
    for mesh in ("single", "multi"):
        assert (report.roofline_table(cells, mesh)
                == jax_report.roofline_table(cells, mesh))
        assert (report.dryrun_table(cells, mesh)
                == jax_report.dryrun_table(cells, mesh))
    assert report.roofline_table(cells, "single").count("\n") == 5


# ------------------------------------------------------ roofline logic
def test_roofline_bottleneck_logic():
    class W:  # minimal stand-in
        dot_flops = roofline.PEAK_FLOPS  # exactly 1 s of compute
        coll_counts = {"all-reduce": 1}
        coll_raw = {"all-reduce": 1e9}
        coll_effective = roofline.LINK_BW / 10  # 0.1 s

    class M:
        traffic_bytes = roofline.HBM_BW * 2  # 2 s of HBM -> memory-bound

    r = roofline.analyze_walk(W(), M(), n_chips=4, model_flops=100e12)
    assert r.bottleneck == "memory"
    assert np.isclose(r.compute_s, 1.0)
    assert np.isclose(r.memory_s, 2.0)
    assert np.isclose(r.collective_s, 0.1)
    assert np.isclose(r.step_time_s, 2.0)
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW) == (
        989e12, 3.35e12, 450e9)
    # the ring model: n = 4 ranks, an operand of 100 bytes
    assert roofline.ring_bytes("all-reduce", 4, 100, 100) == 150
    assert roofline.ring_bytes("all-gather", 4, 100, 400) == 300
    assert roofline.ring_bytes("reduce-scatter", 4, 400, 100) == 300
    assert roofline.ring_bytes("all-to-all", 4, 100, 100) == 75
    assert roofline.ring_bytes("collective-permute", 4, 100, 100) == 100


# --------------------------------------------------- per-rank counting
@pytest.mark.parametrize("mesh_shape", [(1, 1), (2, 2)])
def test_trace_walk_counts_this_ranks_products(fake_world, mesh_shape):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    fake_world(mesh_shape[0] * mesh_shape[1])
    mesh = make_host_mesh(mesh_shape, ("data", "model"))
    n_d, n_m = mesh_shape
    M, K, N = 64, 128, 256

    def placed(shape, pl, dtype=torch.bfloat16):
        local = list(shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                local[p.dim] //= mesh.size(i)
        return DTensor.from_local(
            torch.empty(local, dtype=dtype, device="meta"), mesh, pl,
            run_check=False, shape=torch.Size(shape),
            stride=(shape[1], 1))

    x = placed((M, K), (Shard(0), Replicate()))
    w = placed((K, N), (Shard(0), Shard(1)))
    with StepTrace() as walk:
        wr = w.redistribute(mesh, (Replicate(), Shard(1)))   # the gather
        y = x @ wr
    assert tuple(y.shape) == (M, N)
    assert y.placements == (Shard(0), Shard(1))
    glob = 2 * M * K * N
    # every rank computes its (M / n_d) x (N / n_m) block
    assert walk.dot_flops == glob / (n_d * n_m)
    if mesh_shape == (2, 2):
        assert walk.dot_flops == glob / 4
        shard = (K // 2) * (N // 2) * 2                      # bf16 bytes
        assert walk.coll_counts == {"all-gather": 1}
        assert walk.coll_raw == {"all-gather": shard}
        assert walk.coll_effective == 0.5 * 2 * shard        # (n-1)/n result
    else:
        assert walk.coll_counts == {}
    assert walk.peak_bytes > 0

    # a row-parallel product: its partial sum over "model" reduced whole
    # (an all-reduce) or onto column blocks (a reduce-scatter)
    xm = placed((M, K), (Shard(0), Shard(1)))
    wm = placed((K, N), (Replicate(), Shard(0)))
    with StepTrace() as walk:
        part = xm @ wm
        whole = part.redistribute(mesh, (Shard(0), Replicate()))
        cols = part.redistribute(mesh, (Shard(0), Shard(1)))
    assert whole.shape == cols.shape == (M, N)
    assert walk.dot_flops == glob / (n_d * n_m)
    if mesh_shape == (2, 2):
        block = (M // 2) * N * 2                             # bf16 bytes
        assert walk.coll_counts == {"all-reduce": 1, "reduce-scatter": 1}
        assert walk.coll_raw == {"all-reduce": block, "reduce-scatter": block}
        assert walk.coll_eff_by_kind == {"all-reduce": 2 * 0.5 * block,
                                         "reduce-scatter": 0.5 * block}
    else:
        assert walk.coll_counts == {}


def test_kernels_fake_ops_give_shapes_and_formula_flops():
    """Under ``FakeTensorMode`` on the meta device each kernel's op gives
    its outputs' shapes and its formula's FLOPs, and launches nothing; a
    plain meta tensor is refused (``test_torch_flash.py``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = (fa.flash_attention_cuda.launches,
                fa.flash_attention_bwd_cuda.launches,
                ssd.ssd_scan_cuda.launches)
    b, hq, hk, s, d = 2, 4, 2, 256, 64
    with FakeTensorMode():
        q = torch.empty(b, hq, s, d, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        k, v = (torch.empty(b, hk, s, d, dtype=torch.bfloat16,
                            device="meta", requires_grad=True)
                for _ in range(2))
        with StepTrace() as walk:
            out = ops.flash_attention(q, k, v, causal=True, window=100)
            out.backward(torch.empty_like(out))
        assert out.shape == q.shape and out.device.type == "meta"
        assert k.grad.shape == k.shape
    fwd = fa.flash_work(q.shape, k.shape, 2, True, 100)[0]
    bwd = fa.flash_bwd_work(q.shape, k.shape, 2, True, 100)[0]
    assert fwd == 4 * d * int(fa.ref.attention_mask(s, s, True, 100).sum()) \
        * b * hq
    assert walk.kernel_calls == {"flash_attention_fwd": 1,
                                 "flash_attention_bwd": 1}
    assert walk.dot_flops == fwd + bwd

    with FakeTensorMode():
        x = torch.empty(2, 200, 8, 64, dtype=torch.bfloat16, device="meta")
        dt = torch.empty(2, 200, 8, device="meta")
        A, D = torch.empty(8, device="meta"), torch.empty(8, device="meta")
        Bm, Cm = (torch.empty(2, 200, 1, 128, dtype=torch.bfloat16,
                              device="meta") for _ in range(2))
        with StepTrace() as walk:
            y, state = ops.ssd_scan(x, dt, A, Bm, Cm, D, chunk=128,
                                    return_state=True)
        assert y.shape == x.shape and state.shape == (2, 8, 64, 128)
    assert walk.kernel_calls == {"ssd_scan_fwd": 1}
    assert walk.dot_flops == ssd.ssd_work(x.shape, 1, 128, 128, 2)[0]
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches,
            ssd.ssd_scan_cuda.launches) == launches


def test_flash_fake_ops_trace_every_width_and_batch():
    """The flash ops' fake implementations plan head widths off the
    multiple of 8 (padded on the card), past 128 (column slices) and
    batches past the grid's 65,535 (folded) and pairs past one launch's
    (several launches), so the dry-run traces them on meta tensors: the
    unpadded shapes, the formula's FLOPs of the real width, nothing
    launched."""
    for b, hq, hk, d in ((2, 4, 2, 20), (2, 16, 2, 256), (1, 64, 1, 520),
                         (70_000, 2, 1, 16), (65_536, 32_768, 1, 8)):
        _fake_flash_traces(b, hq, hk, d)


def _fake_flash_traces(b, hq, hk, d):
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = (fa.flash_attention_cuda.launches,
                fa.flash_attention_bwd_cuda.launches)
    s = 128
    with FakeTensorMode():
        q = torch.empty(b, hq, s, d, dtype=torch.bfloat16, device="meta",
                        requires_grad=True)
        k, v = (torch.empty(b, hk, s, d, dtype=torch.bfloat16,
                            device="meta", requires_grad=True)
                for _ in range(2))
        with StepTrace() as walk:
            out = ops.flash_attention(q, k, v, causal=True, window=100)
            out.backward(torch.empty_like(out))
        assert out.shape == q.shape and k.grad.shape == k.shape
        assert q.grad.shape == q.shape
    assert walk.kernel_calls == {"flash_attention_fwd": 1,
                                 "flash_attention_bwd": 1}
    assert walk.dot_flops == (fa.flash_work(q.shape, k.shape, 2, True, 100)[0]
                              + fa.flash_bwd_work(q.shape, k.shape, 2, True,
                                                  100)[0])
    assert (fa.flash_attention_cuda.launches,
            fa.flash_attention_bwd_cuda.launches) == launches


# ----------------------------------------- against the reference's HLO
SMOKE = [("internlm2-1.8b", 2), ("granite-moe-1b-a400m", 2),
         ("mamba2-130m", 2), ("qwen3-32b", 1)]
B, S = 4, 32
PAD = 512          # the reference's loss chunk and flash_xla's key chunk
# measured: the port's count plus the two paddings is within 0.9% of the
# HLO walk's for each of the four smoke archs
HLO_TOL = 0.02

_HLO = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
from repro.analysis import hlo_walk
from repro.configs import get_config
from repro.dist import named, param_pspec_tree
from repro.dist.act_sharding import activation_shardings
from repro.models import build_model
from repro.train import OptConfig, adamw_init, make_train_step
out = {}
for arch, mb in json.loads(sys.argv[1]):
    model = build_model(get_config(arch, smoke=True))
    mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
    pshapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    step = make_train_step(model, OptConfig(), microbatches=mb,
                           param_shardings=named(
                               mesh, param_pspec_tree(pshapes, mesh)))
    batch = {k: jax.ShapeDtypeStruct((4, 32), jnp.int32)
             for k in ("tokens", "labels")}
    with mesh, activation_shardings(mesh):
        lowered = jax.jit(step).lower(pshapes,
                                      jax.eval_shape(adamw_init, pshapes),
                                      batch)
    w = hlo_walk.analyze_hlo(lowered.compile().as_text(), default_group=4)
    out[arch] = {"flops": w.dot_flops, "counts": w.coll_counts,
                 "raw": w.coll_raw, "eff": w.coll_eff_by_kind}
print("WALKS " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def hlo_walks():
    """The reference's HLO walk of each smoke arch's step on a (2, 2)
    mesh of 4 CPU devices: dot FLOPs and collectives by kind."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _HLO, json.dumps(SMOKE)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [s for s in proc.stdout.splitlines() if s.startswith("WALKS ")]
    return json.loads(line[0][len("WALKS "):])


@pytest.fixture(scope="module")
def port_walks():
    """The port's trace of the same steps (the plain versions on fake CPU
    tensors) over a 4-rank fake group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        mesh = make_host_mesh((2, 2), ("data", "model"))
        return {arch: dryrun.lower_cell(
                    arch, ShapeSpec("smoke", S, B, "train"), mesh,
                    microbatches=mb, device="cpu",
                    cfg=get_config(arch, smoke=True))[0]
                for arch, mb in SMOKE}
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch,microbatches", SMOKE)
def test_traced_dot_flops_match_the_hlo_walk(hlo_walks, port_walks, arch,
                                             microbatches):
    """Two sources of difference, both dots on padding that the
    reference runs and the port does not: (1) the reference pads the loss
    to chunks of 512 positions, so its unembedding runs over 512 - S more
    positions (forward and two backward products); (2) its ``flash_xla``
    pads the key axis to its chunk of 512, so each attention layer's four
    forward and backward score products run over 512 - S more keys (six
    products of 2 * Dh a pair, per query head).  Counted per rank: the
    rows over ``data``, the vocabulary and the heads over ``model``."""
    cfg = get_config(arch, smoke=True)
    walk = port_walks[arch]
    rows, tp = B // 2, 2
    loss_pad = 3 * 2 * rows * (PAD - S) * cfg.d_model * (cfg.vocab // tp)
    n_attn = sum(cfg.mixer_kind(i % cfg.period) == "attn"
                 for i in range(cfg.n_layers))
    attn_pad = n_attn * 6 * 2 * rows * (cfg.n_heads // tp) * S * (PAD - S) \
        * cfg.d_head
    want = hlo_walks[arch]["flops"]
    got = walk.dot_flops + loss_pad + attn_pad
    assert abs(got - want) <= HLO_TOL * want, (walk.dot_flops, got, want)


def _gather_bytes(cfg, specs, leaf_filter) -> tuple[int, int]:
    """(count, bytes) of one rank's gathers of the parameter leaves that
    ``leaf_filter(path)`` keeps and whose spec names ``"data"``: one per
    leaf and layer, of its local shard in the compute dtype."""
    n = nbytes = 0
    item = cfg.compute_dtype.itemsize
    for path, x in tree.leaves_with_path(build_model(cfg).param_specs()):
        spec = specs
        for k in path:
            spec = spec[k]
        named_axes = [a for e in spec if e is not None
                      for a in (e if isinstance(e, tuple) else (e,))]
        if "data" not in named_axes or not leaf_filter(path):
            continue
        layers = x.shape[0] if path[0] == "periods" else 1
        n += layers
        nbytes += math.prod(x.shape) // 2 ** len(named_axes) * item  # 2 a axis
    return n, nbytes


@pytest.mark.parametrize("arch,microbatches",
                         [c for c in SMOKE if c[0] != "mamba2-130m"])
def test_traced_all_gathers_match_the_hlo_walk(hlo_walks, port_walks, arch,
                                               microbatches):
    """The port's all-gathers, by count, operand bytes and ring bytes,
    against the reference's HLO walk of the same step.  Both gather each
    FSDP weight shard over ``"data"`` (2 ranks) once per layer and
    microbatch in the forward, the experts' included.  The named
    differences:

    (1) XLA gathers each dense layer weight again in the backward; the
        port's autograd keeps the forward's gathered weight (no remat at
        smoke widths), and XLA too keeps the expert weights gathered;
    (2) the unembedding table: XLA hoists its gather out of the
        microbatch loop and gathers it twice (forward, backward), the
        port once per microbatch;
    (3) the embedding: the port gathers its vocabulary shard over
        ``"data"`` once per microbatch (the vocabulary-parallel lookup);
        XLA's lookup gathers no table;
    (4) labels: XLA gathers each microbatch's labels in its loss; the
        port gathers none (with microbatches, ``_split_mb`` sends each
        microbatch's rows of the tokens and labels to their ranks by an
        all-to-all, which is not an all-gather).

    mamba2 is left out: its mixer's activations are laid out otherwise
    (XLA permutes the convolution's halo and gathers heads, the port
    gathers the channels its head split and norm need), so its
    collectives differ by design, not by accounting."""
    cfg = get_config(arch, smoke=True)
    walk, ref = port_walks[arch], hlo_walks[arch]
    mb, dp, tp, item = microbatches, 2, 2, cfg.compute_dtype.itemsize
    specs = param_pspec_tree(build_model(cfg).param_specs(),
                             AbstractMesh(("data", "model"), (2, 2)))
    dense = _gather_bytes(cfg, specs, lambda p: p[0] == "periods" and not (
        cfg.moe is not None and p[-2] == "mlp"))
    table = cfg.vocab * cfg.d_model // (dp * tp) * item
    labels = (mb, B // dp // mb * S * 4)
    want_n = (walk.coll_counts["all-gather"] + mb * dense[0] - mb
              + labels[0] + (2 - mb))
    want_b = (walk.coll_raw["all-gather"] + mb * dense[1] - mb * table
              + labels[0] * labels[1] + (2 - mb) * table)
    assert ref["counts"]["all-gather"] == want_n
    assert ref["raw"]["all-gather"] == want_b
    # every gather runs over 2 ranks: the ring moves the operand once
    assert walk.coll_eff_by_kind["all-gather"] == walk.coll_raw["all-gather"]
    assert ref["eff"]["all-gather"] == ref["raw"]["all-gather"]
