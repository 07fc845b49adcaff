"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``repro_torch`` (never JAX, never the JAX package ``repro``) through
its paths on the card, the event engine, the serving engine (with every
family of the model zoo), the training loop, the elastic trainer and the
mesh layer, and fails with a non-zero exit code if any phase fails:

1. build     compile every kernel of the three paths from
             ``src/repro_torch/csrc`` (one nvcc per source, started together)
             and print nvcc's register, shared-memory and spill lines; count
             the tensor-core instructions (``HGMMA``) in the flash, flash
             backward, SSD and SSD backward libraries' SASS (``cuobjdump
             -sass``), which must be more than 0 in each; print each flash and
             flash backward kernel's registers and spills, which must be 0
             for every one of them (bf16 and f32), and each SSD backward
             kernel's; hold the geometry (flash:
             key tile, threads, shared memory; flash backward: other
             side's tile, threads, shared memory of each kernel; SSD and
             its backward: each launch's threads and shared memory, for
             each tile of rows) that
             the ``kernel_plan`` functions report against the
             built library's, for every instantiation and every flash head
             width (8 to 128 in steps of 8, and 4, 20, 100 padded, 136,
             192, 256 on the native bf16 kernels and 264, 512, 520 on the
             wide ones; f32 past 128 on the whole-width kernels); the flash
             libraries' nvcc seconds
             beside those of the sources before the narrow widths
2. kernels   each kernel against its plain PyTorch version on the card at the
             paths' shapes, with its device time (CUDA-graph replay, or CUDA
             events for calls of many milliseconds), the plain version's,
             its time per call with the enqueue, and its bound.  Advance
             sweep: ``dt`` bitwise, ``rem'`` within rtol 1e-6 / atol 1e-5,
             also at ``[70000, 8193]`` (rows past the split grid's 65,535).
             Flash attention: within 2e-5 (f32) / 2e-2 (bf16) at eleven
             shapes, and by relative error of the whole output and of its
             worst row within 1e-5 (f32) / 4e-3 and 8e-3 (bf16), from the
             serving prefill to a gemma2-27b local layer and phase 6b's
             (granite-moe, jamba and qwen2-vl prefills, whisper's encoder
             and its cross-attention at a decode step), each with
             its launch plan (bf16 on the tensor cores, f32 on the CUDA
             cores; f32 query tiles that leave SMs idle split their keys),
             with ``scaled_dot_product_attention`` timed as a yardstick
             where it computes the same function (``sdpa_kwargs``: where
             Sq < Sk under the causal mask, through ``causal_lower_right``,
             whose output is first held to the plain version's); and, in
             bf16 and f32, every case of the Pallas kernel's test widths 16
             and 32 (``tests/test_torch_flash.py`` CASES), a smoke model's
             serving prefill (D 16) and a width between instantiations (D
             80), under the same limits; the widths past the narrow
             domain (PR 30, ``WIDE_SHAPES``): the attention of
             Qwen3-Next-80B-A3B ``[1, 16/2, 4096, 256]`` and of
             DeepSeek-V4-Flash ``[1, 64/1, 4096, 512]`` (window 128) in
             bf16, f32 ``[2, 4/2, 300, 300, D]`` at D 4, 20, 136, 192,
             256, 520 and Qwen3-Next's attention in f32, bf16 at
             D 136 (MQA, window, Sq < Sk) and 192 (GQA, softcap), and a
             batch of 66,000 in both dtypes (the folded grid), each with
             its plan's variant (bf16 136-256 and f32 past 128 the
             whole-width kernels), width and column slices (the times S is
             formed), the op's padding copies timed apart, and SDPA's time
             and backend (the longest kernel of a profiled call; a window
             through its mask).  SSD scan: within 2e-2 (bf16) of
             the plain chunked version at mamba2-130m's training shape and
             a jamba-shaped one, and by relative error of the whole output
             and of its worst (b, h) slice within 3.2e-3 and 5e-3, each with
             its launch plan (three phases, all but the state pass
             chunk-parallel, whose device times a profiled call splits: bf16
             on the tensor cores, f32 on the CUDA cores, a block walking a
             run of a group's heads), in f32 within 2e-4 and 1e-5 of the
             sequential scan at a ragged shape and jamba's layer and of the
             chunked version at mamba2-130m's training shape (no PyTorch
             call computes it); and at the corners of the Pallas kernel's
             domain (chunks 256, 160, 100, 48 and 8, P and N padded
             and past 128, a batch of 66,000), through the decomposition,
             against the plain version at the asked chunk; at each shape the
             final state (``return_state``, the prefill's output) against
             the chunked version's, within 2e-4 (f32) and by the relative
             errors of the whole state and its worst (b, h) slice under y's
             limits (bf16), y beside it bitwise y without it, and its time;
             ``SSDScan``'s gradients (both kernels) within 1e-4 of each
             leaf's largest value.  SSD backward, at the SSD shapes, from an
             output gradient: dx, ddt, dA, dBm, dCm, dD against
             ``ref.ssd_scan_bwd_ref``, f32 each within 1e-4 of its largest
             value, bf16 by the relative error of each whole gradient and
             of its worst (b, h) slice (``SSD_BWD_REL_TOL``,
             ``SSD_BWD_SLICE_TOL``); two calls bitwise equal; its plan
             (a group's heads walked in runs; bf16 ``"wgmma"``: TMA and
             wgmma; f32 on the CUDA cores), the six launches' device times
             from a profiled call, each beside the whole call's bound, its
             registers and spills, its time beside the plain backward's
             (autograd through ``ref.ssd_scan_ref``, what the card ran
             before the kernel) and the explicit plain version's.  Flash
             backward: at phase 8b's training shapes, a
             gemma2-27b local layer (window, softcap, logits scaled into the
             cap's bend), phi3's head dim, rows offset or without keys and
             the narrow and padded widths of the forward, the forward's lse
             against ``ref.attention_lse_ref`` (1e-4, +inf
             exactly on rows without keys, the output bitwise the output
             without lse), then dq, dk, dv from that output and lse against
             ``ref.attention_bwd_ref``: f32 within 1e-4 of each tensor's
             largest value, bf16 by relative error of the whole tensor and
             of its worst row within 5e-3 and 1.05e-2; two calls bitwise
             equal; exactly zero dq on rows without keys; the backward's,
             the plain version's, the forward's with and without lse and
             SDPA's backward time
3. anchors   the paper's experiments through ``simulate`` on the card: Fig. 4
             (four policy pairs), Table 1, Fig. 9/10 at 10,000 hosts and
             Fig. 7/8 at 100,000 hosts, each against the port's own CPU run
             (integer fields exact, float fields rtol 1e-5)
4. campaign  1024 Fig. 9/10 rows at 10,000 hosts as one batch-major run;
             rows 0 and 1 bitwise their solo runs
4b. extensions  the event loop's extensions through ``simulate``,
             ``simulate_instrumented`` and ``simulate_trace`` on the card:
             (a) each extension constructor (evacuation and its
             restart-from-zero control, consolidation and balance with and
             without migration, Table 1 with live migration, autoscale on
             and off, reliability from a torch seed and its MTBF = INF
             control, generated poisson / diurnal / bursty, serving) against
             the port's CPU run, with its anchor; (b) ``simulate_trace`` of
             Fig. 9/10 at 10,000 hosts (50 samples; result bitwise the
             untraced run, progress within rtol 1e-5 of the CPU trace) and
             of phase 4's campaign (result bitwise the untraced campaign);
             (c) 512 ``reliability_scenario`` rows at Fig. 9/10's scale
             (10,000 hosts, 50 VMs, 500 cloudlets of 1,200 s), an MTBF x
             policy grid over seeds, with launches per batch step, the
             provisioning loop's share and the idle share from a profiled
             window of batch steps; (d) 1024-row autoscale (burst rate x
             threshold x seed) and consolidation (consolidate x balance
             threshold) campaigns; in (c) and (d) two rows bitwise their
             solo runs, which equal the port's CPU runs
4c. network and campaigns  the inter-DC topology and the streamed campaign
             driver on the card: (a) ``staging_scenario`` with locality
             dispatch off and on, Table 1 over ``Topology.from_coordinates``
             and evacuation under a topology against the port's CPU runs;
             Table 1 and Fig. 9/10 at 10,000 hosts under a neutral topology
             bitwise their flat runs (Table 1 with 8 VMs, one migration,
             as in the reference's lock); Table 1 and Fig. 9/10 at 10,000 hosts
             with the federated-energy topology through ``simulate_trace``
             against the CPU's traces; a ``K_STAGE`` event in
             ``simulate_history``; (b) 1,024 ``staging_scenario`` rows (8 DCs
             x 125 hosts, 128 VMs, 512 cloudlets in waves of 64) over an
             input size x link rate x latency x locality grid, rows 0 and 1
             bitwise their solo runs, which equal the CPU's, with a profiled
             window of batch steps; (c) 8,192 Fig. 9/10 rows at 10,000 hosts
             held on the host and streamed through ``run_campaign`` in
             chunks of 1,024 and 2,048 with five reducers (integer folds,
             ``ArgBest`` and ``Values`` bitwise across the two, means within
             rtol 1e-5, one chunk's folds bitwise the fold of its
             materialised result); (d) ``successive_halving`` over Table 1
             (64 candidates, 3 rungs) equal to the CPU's on the same table
5. proof     the advance-sweep kernel's launch count over phases 3-4c; after
             phase 7, that serving launched no flash backward and made no
             checkpoint; after phase 8b, the flash launches it counted;
             after phase 10, each kernel's launches there, as its runs
             counted them
6. serving   internlm2-1.8b at full width and depth (bf16, random weights from
             a seed) served by ``ServingEngine`` (4 slots of 1,024 tokens,
             re-planning by simulation every 8 steps) to 8 requests of 128-512
             prompt tokens and 32 new tokens; every request done, the flash
             kernel launched once per layer per prefill, the advance sweep
             launched by the re-plans; wall time, prefill and decode tokens/s,
             the flash kernel's share of device time, peak memory; then,
             outside the counted run, one ``Model.prefill`` of a single
             8,192-token prompt: prefill tokens/s and flash's share of its
             device time
6b. model zoo  the other families through their entry points (bf16
             compute, f32 weights from a seed): (a) granite-moe-1b-a400m at
             full width and depth and (b) jamba-v0.1-52b at full width cut to
             one period of 8 layers, each served by ``ServingEngine`` as
             phase 6 serves (8 requests of 32 new tokens; 4 of 16): every
             request done, flash launched once per attention layer per
             prefill, the SSD kernel once per SSM layer per prefill and the
             plain chunked SSD never on the card; (c) whisper-large-v3 at
             full width and depth: ``Model.prefill`` of 2 x 1,500 frame
             embeddings and a 64-token prompt, 16 greedy decode steps,
             flash launched 32 + 32 + 32 times a prefill and 32 a step (the
             cross-attention); (d) qwen2-vl-72b at full width cut to 2
             layers: a prefill of 1,024 patch embeddings and 256 tokens
             with M-RoPE positions, 8 decode steps.  Each: a profiled run's
             device time by kind of kernel (flash, SSD, GEMMs, the MoE
             dispatch's index and sort ops, the casts), the idle share;
             wall, prefill and decode tokens/s, peak memory
7. parity    internlm2-1.8b at full width, 2 layers, f32: prefill logits and
             8 greedy decode steps on the card against the port's CPU run
             (logits within atol/rtol 1e-3, tokens identical); the same for
             granite-moe (2 layers; the chosen experts compared first, a
             differing choice allowed only at a probability gap of at most
             1e-5, and then reported as a tie), whisper (2 + 2 layers, also
             the cross K/V caches) and qwen2-vl (1 layer, 16 patch
             embeddings + 16 tokens with M-RoPE positions, 4 steps); one of
             jamba's SSM layers: ``ssm_prefill`` of 300 tokens (the f32
             kernel with its state) and 8 ``ssm_decode`` steps, y, the conv
             tail and the state within 1e-3 of each one's largest value
8. train     mamba2-130m at full width and depth (bf16 compute, f32 master
             weights and AdamW) trained by ``run_training`` for 20 steps of
             8 x 2,048 tokens on the Markov pipeline: losses and gradient
             norms finite, the last 5 steps' mean loss below the first
             step's, the SSD kernel launched twice per layer per step (the
             checkpointed period runs its forward again) and its backward
             once, the SSD's plain versions never on the card;
             tokens/s, step time, the SSD kernels' share of device time over
             2 profiled steps (every ``ssd_fwd*`` and ``ssd_bwd*`` kernel,
             each one's time printed), the idle share, peak memory
8b. dense train  the attention models through the normal entry points
             (bf16 compute, f32 weights and AdamW, remat on): internlm2-1.8b
             at full width and depth for 12 steps of 8 x 2,048 tokens and
             granite-moe-1b-a400m for 5 of 4 x 2,048 by ``run_training``,
             whisper-large-v3 for 3 steps of 2 x 1,500 frames and 64 tokens
             by ``make_train_step``: losses and gradient norms finite,
             internlm2's last 5 steps' mean loss below its first, flash
             forward launches = 2 x attention layers x steps and backward =
             attention layers x steps; tokens/s, peak memory; 2 profiled
             internlm2 steps with device time by kernel class (flash
             forward, each backward kernel, GEMMs, casts, AdamW,
             elementwise) and the idle share
9. train parity  one train step and its gradients on the card against the
             CPU (loss and gradient norm rtol 1e-4, each gradient leaf
             within 1e-3 of its largest value), f32: mamba2-130m at full
             width, 2 layers (and ``lm_logits`` within atol/rtol 1e-3),
             internlm2-1.8b at full width, 2 layers, a narrow gemma2 (window
             under the sequence, both softcaps) and a narrow whisper, the
             attention models through the f32 flash forward and backward
             kernels, mamba2 through the f32 SSD forward and backward
             kernels (launches counted)
10. elastic and mesh  (a) ``ElasticRunner`` on mamba2-130m at full width
             and depth (bf16 compute, remat on), 24 steps of 8 x 2,048
             tokens, checkpoints every 6 steps into a temporary directory,
             failures injected at steps 10 and 17: events failure, failure,
             finished, resumed from steps 6 and 12, a finite final loss,
             the SSD kernel launched twice per layer for each of the 33
             steps run, and the advance sweep once per batch step of the
             two restart plans' four simulations; (b) internlm2-1.8b at
             full width and depth under ``remat_policy="save_named"`` for 4
             steps of phase 8b's tokens: losses equal phase 8b's first 4
             (``"none"``; reported whether bitwise), the flash forward twice
             and the backward once per layer per step, one tag copy per
             tagged value per forward, step time and peak memory beside
             phase 8b's, then one gradient's peak memory under each
             policy (the run's peak is AdamW's); (c) the mesh layer on one card, NCCL at world size
             1 on a ``(1, 1)`` ``("data", "model")`` mesh: granite-moe's MoE
             layer at full width, f32, through the expert-parallel path at
             both schedules against the local path (within 2e-4, aux 1e-4),
             phase 4's 1,024-row campaign through ``run_campaign(mesh=)``
             bitwise phase 4's result, and internlm2's parameters through
             ``named`` + ``distribute_tensor`` (``full_tensor()`` bitwise
             each leaf); the process group is destroyed at the end
11. sharded step and dry-run  (a) the sharded train step on the card: NCCL
             at world size 1 on a ``(1, 1)`` mesh, ``DTensor`` parameters
             from ``distribute`` of the plain run's init by
             ``param_pspec_tree``, AdamW moments from ``adamw_init``, the
             batch from ``input_pspec_tree``, ``param_shardings`` from
             ``named``, the step inside ``activation_shardings``:
             internlm2-1.8b at full width and depth for 3 of phase 8b's
             steps (losses within 1e-6 relative of phase 8b's, the gap
             printed; the flash forward 48 and backward 24 times a step,
             each forward call through ``local_map``; the third step's time
             and the peak memory beside phase 8b's) and mamba2-130m for 2 of
             phase 8's steps (losses within 1e-6 relative, 48 SSD launches
             a step through ``local_map``); (b) the dry-run's ``lower_cell``
             of (a)'s internlm2 cell on a ``(1, 1)`` mesh over a fake
             process group, on fake meta tensors: the roofline's
             ``step_time_bound_s`` and bottleneck and
             ``analysis.memory.estimate``'s residency beside (a)'s measured
             step time and peak memory; (c) one full-size cell,
             ``run_cell("internlm2-1.8b", TRAIN_4K, "single")`` over a fake
             group of 256 ranks: its per-device residency and bottleneck
12. lint and examples  (a) ``simlint.run_lint(device="cuda")``, every rule
             over every entry: zero error findings; each rule's status, the
             operators a batch step enqueues and ``host_any``'s syncs a step
             (R6 holds the four kernels' plans against their loaded
             libraries; R3 runs every instrument hook under
             ``set_sync_debug_mode("error")``); (b) the six twins of
             ``examples/`` in ``examples_torch/``, each a subprocess on the
             card at its default size and one on the CPU (``train_100m``
             for its first 5 steps), with a timeout each: every one exits
             0, and Fig. 4's analytic 1,500 / 1,800 / 2,400 s, the Table 1
             cuts, the search's rungs, frontier and winner, the served
             requests, the elastic run's restarts, resume steps and plans,
             and ``train_100m``'s first 5 losses (rtol 1e-4, as phase 9)
             equal the CPU run's; the serving and elastic twins run the
             reference's smoke internlm2 (heads 16 wide)
13. smoke zoo  ``get_config(arch, smoke=True)`` of every arch of the
             registry (heads 16 wide), in f32 and bf16, from one CPU draw of
             the weights: served (``ServingEngine``; ``Model.prefill`` and
             ``decode_step`` for whisper and qwen2-vl) and trained for 3
             steps (``run_training`` from a step-0 checkpoint of those
             weights; ``make_train_step`` for whisper and qwen2-vl) on the
             card and on the CPU.  f32: every call's logits within 1e-3 and
             the same greedy tokens, losses and gradient norms within 1e-4
             relative; bf16: logits of a prefill and 6 decode steps fed the
             CPU's greedy tokens, and losses, within 2e-2 relative (the
             kernels' bf16 tolerance).  Every attention arch launches the
             flash forward and backward, every SSM arch the SSD kernel and
             its backward
14. wide heads  gemma2's and internlm2's smoke models with ``d_head``
             widened to 256 (the whole-width kernels in both dtypes), 512
             (the wide ones in bf16, the f32 whole-width ones in two
             slices) and 20 (padded to 24), f32 and bf16, served and trained
             for 3 steps on the card and the CPU as phase 13 does: every
             flash launch native, wide or padded, the flash kernels' plain
             versions 0 times on the card

Every line of numbers carries the card's name and power limit.  The line
before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the script exits
with an error before printing any result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.nn.attention.bias import causal_lower_right

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device is available")

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.analysis import memory as memest, roofline  # noqa: E402
from repro_torch.analysis import simlint  # noqa: E402
from repro_torch.convert import result_to_numpy  # noqa: E402
from repro_torch.core import (  # noqa: E402
    INF, SPACE_SHARED, TIME_SHARED, ArgBestReducer, HistogramReducer,
    MeanReducer, Outages, PowerModel, Scenario, SumReducer, Topology,
    ValuesReducer, broadcast_campaign, engine, provision, run_campaign,
    scenario_row, scenarios, search, simulate, simulate_history,
    simulate_instrumented, simulate_trace, stack_scenarios, step, workload)
from repro_torch.ckpt import save as ckpt_save  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.build import head_grid  # noqa: E402
from repro_torch.data import ShardedLoader  # noqa: E402
from repro_torch.kernels import (  # noqa: E402
    flash_attention, ops, ref, ssd_scan, vm_update)
from repro_torch.dist import (  # noqa: E402
    activation_shardings, distribute, input_pspec_tree, named,
    param_pspec_tree)
from repro_torch.launch.elastic import (  # noqa: E402
    ElasticRunner, restart_scenario)
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.train import run_training  # noqa: E402
from repro_torch.models import (  # noqa: E402
    TRAIN_4K, build_model, layers, lm, moe, ssm)
from repro_torch.models.config import ShapeSpec  # noqa: E402
from repro_torch.models.lm import lm_logits  # noqa: E402
from repro_torch.serving import ServingEngine  # noqa: E402
from repro_torch.train import (  # noqa: E402
    OptConfig, adamw_init, adamw_update, make_train_step)
from repro_torch.train.step import value_and_grad  # noqa: E402

# the plain versions and the parity phase compare in full f32 (no TF32)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# the H100 SXM's peak figures, one copy for the bounds and the dry-run
HBM_BYTES_PER_S = roofline.HBM_BW        # device memory
FP32_OPS_PER_S = roofline.FP32_FLOPS     # float32 outside the tensor cores
BF16_OPS_PER_S = roofline.PEAK_FLOPS     # bf16 tensor cores, dense
KERNEL_SHAPES = [(1024, 500), (512, 500), (1024, 48), (1, 500),
                 (1, 131072), (1, 3 * 2**17), (8192, 4096), (70000, 8193)]
# (70000, 8193): rows past the split grid's 65,535 (7.5 GB a pass), whose
# blocks step through the rows
# the advance sweep of the Fig. 9/10 campaign ((512, 500): the reliability
# campaign's; (1024, 48): the autoscale campaign's)
MAIN_SHAPE = (1024, 500)
CAMPAIGN_ROWS = 1024
# the reliability campaign: Fig. 9/10's fleet, VMs and cloudlets over two
# federated datacenters, an MTBF x (evacuation, checkpoint) grid over seeds
RELIABILITY = dict(n_dc=2, hosts_per_dc=5_000, n_vms=50, cl_per_vm=10,
                   task_mi=1_200_000.0)
RELIABILITY_MTBFS = (3e5, 1e6, 1e7, INF)
RELIABILITY_POLICIES = ((True, INF), (True, 600_000.0), (False, INF),
                        (False, 600_000.0))   # (evacuation, ckpt MI = 600 s)
# 512 rows, not 1024: 1024 rows took 69.6 s on an NVIDIA H100 80GB HBM3
# (700 W), over the ~60 s this campaign may take; the per-step cost is the
# host's, so fewer rows cut the provisioning steps, not the batch steps
RELIABILITY_ROWS = 512
PROFILED_FROM, PROFILED_STEPS = 200, 40   # batch steps profiled in (c)
TRACE_SAMPLES = 50
# phase 4c: the staging campaign's rows (input MB x link Mbps x latency s x
# locality dispatch, 24 points, wave_dt spread over the rest), the streamed
# Fig. 9/10 campaign and the successive-halving search over Table 1
STAGING = dict(n_dc=8, hosts_per_dc=125, vms_per_dc=16, n_cloudlets=512,
               wave=64)
STAGING_GRID = [(mb, bw, lat, loc) for mb in (256.0, 1024.0, 4096.0)
                for bw in (100.0, 1000.0) for lat in (0.05, 0.2)
                for loc in (False, True)]
STAGING_ROWS = 1024
STAGING_PROFILED_FROM, STAGING_PROFILED_STEPS = 60, 40
STREAM_ROWS, STREAM_CHUNKS = 8192, (1024, 2048)
HALVING_SPACE = {"migration_fixed_s": [10.0, 30.0, 60.0, 120.0],
                 "interdc_bw_mbps": [25.0, 50.0, 100.0, 400.0],
                 "sensor_interval": [50.0, 100.0, 200.0, 400.0],
                 "best_fit": [False, True]}
HALVING = dict(n0=64, fidelities=(2500.0, 4000.0, 1e7),
               metric="mean_turnaround")
COORDS_KM = np.array([[0.0, 0.0], [1800.0, 0.0], [0.0, 3600.0]])
# flash attention: name, (B, Hq, Hk, Sq, Sk, D), dtype, masking
FLASH_SHAPES = [
    ("serving prefill", (1, 16, 8, 512, 512, 128), torch.bfloat16,
     dict(causal=True)),
    ("long prefill", (1, 16, 8, 8192, 8192, 128), torch.bfloat16,
     dict(causal=True)),
    ("gemma2-27b local layer", (1, 32, 16, 8192, 8192, 128), torch.bfloat16,
     dict(causal=True, window=4096, softcap=50.0)),
    ("phi3 head dim", (2, 32, 32, 1024, 1024, 96), torch.bfloat16,
     dict(causal=True)),
    ("f32 ragged", (2, 4, 2, 300, 300, 64), torch.float32, dict(causal=True)),
    ("offset rows", (1, 16, 8, 128, 1000, 128), torch.float32,
     dict(causal=True)),
    # phase 6b's shapes: granite-moe (D 64, GQA 16/8) and jamba (GQA 32/8)
    # prefills, whisper's encoder and its cross-attention at a decode step
    # (one query row against the 1,500 frames), qwen2-vl's prefill
    ("granite-moe prefill", (1, 16, 8, 512, 512, 64), torch.bfloat16,
     dict(causal=True)),
    ("jamba prefill", (1, 32, 8, 512, 512, 128), torch.bfloat16,
     dict(causal=True)),
    ("whisper encoder", (2, 20, 20, 1500, 1500, 64), torch.bfloat16,
     dict(causal=False)),
    ("whisper cross decode", (2, 20, 20, 1, 1500, 64), torch.bfloat16,
     dict(causal=False)),
    ("qwen2-vl prefill", (1, 64, 8, 1280, 1280, 128), torch.bfloat16,
     dict(causal=True)),
]
# the Pallas kernel's narrow heads: every case of its tests' widths 16 and
# 32 (tests/test_torch_flash.py CASES), the smoke internlm2's prefill of
# examples/serve_model.py's longest prompt (4 query heads over 2 of D 16),
# and a width between instantiations (D 80 runs the 128-column one), each
# in bf16 and f32, forward (phase 1) and backward (phase 2)
NARROW_SHAPES = [
    ("pallas MHA", (1, 2, 2, 64, 64, 32), dict(causal=True)),
    ("pallas GQA", (2, 4, 2, 128, 128, 16), dict(causal=True)),
    ("pallas ragged", (2, 4, 2, 100, 100, 16), dict(causal=False)),
    ("pallas MQA", (1, 4, 1, 96, 224, 32), dict(causal=True)),
    ("pallas window", (2, 4, 2, 160, 160, 32), dict(causal=True, window=32)),
    ("pallas softcap", (2, 4, 2, 160, 160, 32), dict(causal=True,
                                                    softcap=20.0)),
    ("pallas window softcap", (1, 4, 2, 150, 150, 16),
     dict(causal=True, window=48, softcap=50.0)),
    ("pallas window only", (1, 2, 2, 70, 200, 16), dict(causal=False,
                                                        window=64)),
    ("smoke serving prefill", (1, 4, 2, 16, 16, 16), dict(causal=True)),
    ("padded width 80", (2, 16, 8, 512, 512, 80), dict(causal=True)),
]
NARROW = [(f"{name} D {shape[-1]} {str(dtype).split('.')[1]}", shape, dtype,
           kw) for name, shape, kw in NARROW_SHAPES
          for dtype in (torch.bfloat16, torch.float32)]
FLASH_SHAPES += NARROW
FLASH_MAIN = "serving prefill"
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# relative error of the whole output (Frobenius) and of its worst row: an
# elementwise 2e-2 is as large as a typical output element at 8192 keys.
# The bf16 limits are ~1.8x the most the sound kernel gave at these shapes
# on an H100 (2.2e-3, 4.4e-3); a key tile dropped, or read from the wrong
# ring stage, gave 0.08 and 0.85 or more at 8192 tokens
# (scripts/flash_fault_reach.py).
FLASH_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-3}
FLASH_ROW_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}
# the backward: name, (B, Hq, Hk, Sq, Sk, D), dtype, masking; every
# training shape of phase 8b (internlm2, granite-moe, whisper's encoder,
# its cross-attention and its decoder's self-attention), gemma2-27b's local
# layer, phi3's head dim, rows offset against a longer key axis and rows
# that see no key
FLASH_BWD_SHAPES = [
    ("internlm2 training", (8, 16, 8, 2048, 2048, 128), torch.bfloat16,
     dict(causal=True)),
    ("gemma2-27b local layer", (1, 32, 16, 4096, 4096, 128), torch.bfloat16,
     dict(causal=True, window=1024, softcap=50.0)),
    ("phi3 head dim", (1, 32, 32, 1024, 1024, 96), torch.bfloat16,
     dict(causal=True)),
    ("granite-moe training", (4, 16, 8, 2048, 2048, 64), torch.bfloat16,
     dict(causal=True)),
    ("whisper encoder", (2, 20, 20, 1500, 1500, 64), torch.bfloat16,
     dict(causal=False)),
    ("whisper cross", (2, 20, 20, 64, 1500, 64), torch.bfloat16,
     dict(causal=False)),
    ("whisper decoder", (2, 20, 20, 64, 64, 64), torch.bfloat16,
     dict(causal=True)),
    ("f32 offset rows", (1, 16, 16, 128, 1000, 128), torch.float32,
     dict(causal=True)),
    ("f32 rows without keys", (1, 8, 8, 256, 128, 64), torch.float32,
     dict(causal=True)),
    ("bf16 rows without keys", (1, 8, 8, 256, 128, 64), torch.bfloat16,
     dict(causal=True)),
]
FLASH_BWD_SHAPES += NARROW
FLASH_BWD_MAIN = "internlm2 training"
# every head width the Pallas kernel takes (PR 30): the attention of two
# public configs at 4,096 tokens (shapes, not weights: Qwen3-Next-80B-A3B,
# 16 query / 2 KV heads of 256, config.json of
# huggingface.co/Qwen/Qwen3-Next-80B-A3B-Instruct; DeepSeek-V4-Flash, 64 / 1
# heads of 512, a sliding window of 128), f32 at each new width (padded: 4,
# 20; whole-width: 136, 192, 256, 520 in three slices), and a batch past the grid's
# 65,535 in both dtypes; forward (phase 1) and backward (phase 2).
# Qwen3-Next's attention in f32 too: the f32 whole-width kernels at
# a size where their work, and not a short grid's latency, sets the time
WIDE_SHAPES = [
    ("qwen3-next-80b-a3b layer", (1, 16, 2, 4096, 4096, 256), torch.bfloat16,
     dict(causal=True)),
    ("deepseek-v4-flash layer", (1, 64, 1, 4096, 4096, 512), torch.bfloat16,
     dict(causal=True, window=128)),
    ("f32 qwen3-next layer", (1, 16, 2, 4096, 4096, 256), torch.float32,
     dict(causal=True)),
] + [(f"f32 D {d}", (2, 4, 2, 300, 300, d), torch.float32, dict(causal=True))
     for d in (4, 20, 136, 192, 256, 520)] + [
    # the native bf16 kernels below 256: MQA with a window over offset rows,
    # GQA with a softcap
    ("bf16 D 136 MQA window", (2, 4, 1, 300, 500, 136), torch.bfloat16,
     dict(causal=True, window=100)),
    ("bf16 D 192 GQA softcap", (1, 8, 2, 600, 600, 192), torch.bfloat16,
     dict(causal=True, softcap=30.0)),
] + [
    (f"batch past the grid {str(dtype).split('.')[1]}",
     (66000, 2, 1, 8, 8, 16), dtype, dict(causal=True))
    for dtype in (torch.bfloat16, torch.float32)]
# SDPA's backend is named (a profiled call) at the public configs and the
# batches past the grid.  Qwen3-Next's D 256 runs the native bf16 kernels
# (NATIVE_MAIN) and in f32 the f32 whole-width ones (F32_MAIN),
# DeepSeek-V4-Flash's 512 the column slices (WIDE_MAIN).
PUBLIC_WIDE = ("qwen3-next-80b-a3b layer", "deepseek-v4-flash layer",
               "f32 qwen3-next layer")
NATIVE_MAIN, WIDE_MAIN, F32_MAIN = PUBLIC_WIDE
NAMED_BACKEND = PUBLIC_WIDE + tuple(
    name for name, *_ in WIDE_SHAPES if name.startswith("batch past"))
FLASH_SHAPES += WIDE_SHAPES
FLASH_BWD_SHAPES += WIDE_SHAPES
# phase 14: the smoke models of two attention families with heads widened
# past the narrow domain (256: the whole-width kernels in both dtypes; 512:
# the bf16 column slices and the f32 whole-width kernels in two slices;
# padding at 20)
WIDE_HEAD_ARCHS = ("gemma2-27b", "internlm2-1.8b")
WIDE_HEAD_DIMS = (256, 512, 20)
# q scaled so that the logits (std ~6) reach the softcap's bend, as a
# trained gemma2's do: with unit logits the cap of 50 moves dS by ~4e-4
# (at D 16 a dQ without the cap's factor stayed within the limits)
FLASH_BWD_Q_SCALE = {"gemma2-27b local layer": 6.0,
                     "pallas window softcap D 16 bfloat16": 6.0,
                     "pallas window softcap D 16 float32": 6.0}
# f32: each of dq, dk, dv elementwise within 1e-4 of its largest |value|
# (the kernel adds in another order than the plain version); bf16: the
# relative error of the whole tensor and of its worst row (a row's norm
# floored at ROW_FLOOR of the largest row's: the first row under a causal
# mask sees one key and has a zero dq), ~1.8x the most the sound kernel
# gave on an H100 at these shapes (scripts/flash_bwd_fault_reach.py shows
# what they catch); lse within LSE_TOL of the plain version's
FLASH_BWD_TOL = 1e-4
FLASH_BWD_REL_TOL, FLASH_BWD_ROW_TOL, ROW_FLOOR = 5e-3, 1.05e-2, 1e-2
LSE_TOL = 1e-4
SERVE_ARCH = "internlm2-1.8b"
SERVE = dict(n_slots=4, max_len=1024, replan_every=8)
SERVE_REQUESTS, SERVE_NEW_TOKENS = 8, 32
LONG_PROMPT = 8192          # one long prefill outside the counted serving run
# phase 6b: (arch, depth cut or None, requests, new tokens) served as phase 6
# serves internlm2; jamba is cut to one period of 8 layers (53 GB of f32
# weights: its 4 periods would be ~212 GB)
ZOO_SERVE = (("granite-moe-1b-a400m", None, 8, 32),
             ("jamba-v0.1-52b", 8, 4, 16))
WHISPER = dict(batch=2, prompt=64, steps=16)
# qwen2-vl cut to 2 layers (its 80 would be ~290 GB of f32 weights): a
# 32 x 32 grid of patch embeddings, then text
VLM = dict(n_layers=2, patches=1024, grid=32, text=256, steps=8)
# device time by kind of kernel: the first class whose key a kernel's name
# holds (lower case)
KERNEL_CLASSES = (
    ("flash", ("flash_fwd",)), ("flash bwd dK/dV", ("bwd_dkdv",)),
    ("flash bwd dQ", ("bwd_dq",)), ("flash bwd delta", ("bwd_delta",)),
    ("ssd", ("ssd_fwd",)), ("ssd bwd", ("ssd_bwd",)),
    ("advance sweep", ("advance_fused", "advance_tile")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "cublas")),
    ("index, scatter, gather", ("index", "scatter", "gather")),
    ("sort", ("sort",)),
    ("bf16 casts", ("bfloat16_copy",)),
    ("other copies", ("copy",)),
    ("reductions", ("reduce_kernel",)),
    ("elementwise", ("elementwise",)),
)
# SSD scan: name, (B, S, H, P, G, N), dtype, chunk, the plain version held to
SSD_SHAPES = [
    ("mamba2-130m training", (8, 2048, 24, 64, 1, 128), torch.bfloat16, 128,
     "chunked"),
    ("f32 ragged", (2, 300, 8, 32, 2, 64), torch.float32, 128, "sequential"),
    ("jamba-shaped", (1, 4096, 128, 64, 1, 16), torch.bfloat16, 128,
     "chunked"),
    # mamba2-130m trained at dtype="float32", and phase 7's jamba layer
    ("mamba2-130m f32 training", (8, 2048, 24, 64, 1, 128), torch.float32,
     128, "chunked"),
    ("jamba f32 prefill", (1, 300, 128, 64, 1, 16), torch.float32, 128,
     "sequential"),
    # the corners of ssd_scan_pallas's domain that no instantiation takes as
    # they are (ssd_scan.ssd_decomposed): mamba_ssm's default chunk of 256,
    # chunks 160, 100, 48 and 8, P and N padded, P and N past 128 (slices),
    # a batch of 66,000 (the grid's fold); each held to the plain version at
    # the asked chunk
    ("mamba_ssm chunk 256", (2, 1024, 24, 64, 1, 128), torch.bfloat16, 256,
     "chunked"),
    ("P 48 N 24 chunk 160", (2, 200, 2, 48, 1, 24), torch.bfloat16, 160,
     "chunked"),
    ("P 96 N 48 chunk 100", (1, 130, 4, 96, 2, 48), torch.float32, 100,
     "chunked"),
    ("P 8 N 8 chunk 48", (1, 100, 2, 8, 1, 8), torch.float32, 48, "chunked"),
    ("chunk 8", (1, 40, 2, 16, 1, 16), torch.bfloat16, 8, "chunked"),
    ("P 192", (1, 96, 2, 192, 1, 32), torch.bfloat16, 64, "chunked"),
    ("N 256", (1, 96, 4, 32, 2, 256), torch.float32, 32, "chunked"),
    ("P and N 136", (1, 70, 2, 136, 1, 136), torch.bfloat16, 48, "chunked"),
    ("batch 66,000", (66_000, 8, 2, 16, 1, 16), torch.bfloat16, 32,
     "chunked"),
]
# the corners are held, not timed (the kernels they run are the ones the
# shapes above time)
SSD_CORNERS = {name for name, *_ in SSD_SHAPES[5:]}
SSD_MAIN = "mamba2-130m training"
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# relative error of the whole output (Frobenius) and of its worst (b, h)
# slice: the bf16 phases round W, the scaled B rows and the carried state to
# bf16.  The bf16 limits are ~1.8x the most the sound kernel gave on an H100
# (1.8e-3, 2.8e-3 over the card tests' shapes).
SSD_REL_TOL = {torch.float32: 1e-5, torch.bfloat16: 3.2e-3}
SSD_SLICE_TOL = {torch.float32: 1e-5, torch.bfloat16: 5e-3}
# the backward (csrc/ssd_scan_bwd.cu) at SSD_SHAPES against
# ref.ssd_scan_bwd_ref: f32 each gradient within SSD_BWD_TOL of its largest
# |value| (the kernel adds in another order); bf16 by the relative error of
# the whole gradient and of its worst (b, h) slice ((b, g) of dBm and dCm;
# dA and dD whole), ~2x the most the sound kernel gave on an H100 over
# these shapes and tests/test_torch_ssd_bwd_cuda.py's
# (scripts/ssd_fault_reach.py shows what they catch)
SSD_BWD_NAMES = ("dx", "ddt", "dA", "dBm", "dCm", "dD")
SSD_BWD_SLICE_DIMS = ((1, 3), (1,), None, (1, 3), (1, 3), None)
SSD_BWD_TOL = 1e-4
SSD_BWD_REL_TOL = {"dx": 3e-3, "ddt": 2e-3, "dA": 1.1e-2, "dBm": 5.5e-3,
                   "dCm": 5.5e-3, "dD": 1e-6}
SSD_BWD_SLICE_TOL = {"dx": 6e-3, "ddt": 2.7e-3, "dBm": 6e-3, "dCm": 6e-3}
TRAIN_ARCH = "mamba2-130m"
TRAIN = dict(steps=20, global_batch=8, seq_len=2048, lr=1e-3, log_every=5,
             seed=0)
# phase 8b: attention models trained at full width and depth (bf16 compute,
# f32 weights and AdamW, remat on), the same tokens a step as phase 8 for
# internlm2, and whisper through make_train_step
DENSE_TRAIN = (
    ("internlm2-1.8b", dict(steps=12, global_batch=8, seq_len=2048, lr=1e-3,
                            log_every=4, seed=0)),
    ("granite-moe-1b-a400m", dict(steps=5, global_batch=4, seq_len=2048,
                                  lr=1e-3, log_every=2, seed=0)),
)
WHISPER_TRAIN = dict(steps=3, batch=2, tokens=64, lr=1e-3)
DENSE_RUNS: dict = {}    # phase 8b's losses, step seconds and peak, by arch
TRAIN_RUN: dict = {}     # phase 8's losses, step seconds and peak

# phase 10: the reference test's elastic schedule on phase 8's model and
# tokens; the save_named run's steps (all in the warmup, where phase 8b's
# 12-step schedule gives the same learning rates); the MoE layer's token
# counts (granite-moe at full width: 4,096 tokens run the token-gather
# schedule, 16,384 the weight-gather one)
ELASTIC = dict(steps=24, global_batch=8, seq_len=2048, ckpt_every=6,
               n_workers=4, fail_at=[10, 17])
SAVE_NAMED_STEPS = 4
# phase 11: the sharded step's steps of phase 8b's internlm2 run and of
# phase 8's mamba2 run (their losses are held against those runs' within
# SHARDED_LOSS_TOL relative: at world size 1 the same arithmetic)
SHARDED_STEPS = {"internlm2-1.8b": 3, "mamba2-130m": 2}
SHARDED_LOSS_TOL = 1e-6
SHARDED_RUNS: dict = {}  # phase 11's sharded runs, by arch
# phase 12: the twins of examples/, each run on the card at its default
# size and on the CPU; train_100m's CPU run takes the first 5 of its 60
# steps (the warmup: the same learning rates as the card's run)
EXAMPLES = ("quickstart", "federated_cloud", "campaign_search",
            "serve_model", "elastic_restart", "train_100m")
EXAMPLE_CPU_ARGS = {"train_100m": ["--steps", "5"]}
EXAMPLE_TIMEOUT = 240    # seconds a twin may take, on either device
EXAMPLE_RTOL = 1e-5      # engine floats, as phase 3 holds them to the CPU
EXAMPLE_LOSS_RTOL = 1e-4  # losses, as phase 9 holds them to the CPU
MESH_MOE = (("token_gather", 4, 1024), ("weight_gather", 8, 2048))
# phase 13: the JAX package's own smoke model of every family
# (get_config(arch, smoke=True): heads 16 wide), f32 as the configs give it
# and bf16, served (ServingEngine; Model.prefill / decode_step for encdec and
# vlm) and trained (run_training; make_train_step for encdec and vlm) on the
# card and on the CPU from the same CPU-drawn weights
SMOKE_ENGINE = dict(n_slots=2, max_len=64, prompts=(12, 20, 9, 16),
                    new_tokens=6)
SMOKE_GENERATE = dict(batch=2, prompt=16, steps=6, patches=8, grid=4)
SMOKE_TRAIN = dict(steps=3, global_batch=4, seq_len=32, lr=1e-3)
SMOKE_F32_TRAIN_RTOL = 1e-4  # loss and gradient norm, as phase 9
SMOKE_BF16_RTOL = 2e-2      # bf16 logits and losses: the kernels' bf16 tolerance


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


CARD = card()
N_SM = torch.cuda.get_device_properties(0).multi_processor_count


def say(phase: str, text: str) -> None:
    torch.cuda.synchronize()
    print(f"[{CARD}] {phase}: {text}", flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


# --------------------------------------------------------------- 1. build
# nvcc seconds of earlier versions of the libraries, each built alone
# (scripts/build_times.py on an H100 host, PERF.md section 6): the flash
# libraries before their narrow and in-between widths (9 and 24 kernels),
# the SSD libraries before their f32 kernels' chunk-parallel redesign
PREVIOUS_BUILD_S = {
    "flash_attention": (11.09, "before the narrow widths"),
    "flash_attention_bwd": (24.02, "before the narrow widths"),
    "ssd_scan": (27.94, "before the f32 redesign"),
    "ssd_scan_bwd": (57.03, "before the f32 redesign"),
}


def ptxas_kernels(log: str) -> list[tuple[str, int, int]]:
    """(kernel, registers, spill bytes stored and loaded) of each entry
    function in an ``nvcc -Xptxas -v`` log; the kernel named from its
    mangled name with its template's integers and booleans
    (``bwd_dq_wgmma<128, 2, false>``) and element type."""
    out, name, spills = [], None, 0
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(_ZN?)(\w+)'", line)
        if entry:
            # the mangled name's length-prefixed identifiers (a namespace,
            # then the kernel), then its template arguments
            rest, base = entry.group(2), entry.group(1) + entry.group(2)
            while (size := re.match(r"\d+", rest)):
                base = rest[size.end():size.end() + int(size.group())]
                rest = rest[size.end() + int(size.group()):]
            args = rest[1:rest.find("EE")] if rest.startswith("I") else ""
            kind = (["bf16"] if "bfloat16" in args
                    else ["f32"] if args.startswith("f") else [])
            ints = [v if t == "i" else ("true" if v == "1" else "false")
                    for t, v in re.findall(r"L([ib])(\d+)E", args + "E")]
            name = f"{base}<{', '.join(kind + ints)}>"
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill and name:
            spills = int(spill.group(1)) + int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs and name:
            out.append((name, int(regs.group(1)), spills))
            name, spills = None, 0
    return out


SSD_BWD_PTXAS: list = []   # (kernel, registers, spill bytes) of ssd_scan_bwd


def phase_build() -> None:
    built = kbuild.build((vm_update.SRC, vm_update.NVCC_FLAGS),
                         (flash_attention.SRC, flash_attention.NVCC_FLAGS),
                         (ssd_scan.SRC, ssd_scan.NVCC_FLAGS),
                         (flash_attention.SRC_BWD, flash_attention.NVCC_FLAGS),
                         (ssd_scan.SRC_BWD, ssd_scan.NVCC_FLAGS))
    for name, b in zip(("advance_sweep", "flash_attention", "ssd_scan",
                        "flash_attention_bwd", "ssd_scan_bwd"), built):
        took = ("reused an existing build" if b["seconds"] is None
                else f"nvcc {b['seconds']:.3f} s")
        if name in PREVIOUS_BUILD_S:
            seconds, when = PREVIOUS_BUILD_S[name]
            took += f" ({when}, built alone: {seconds} s)"
        say("build", f"{name} {b['path'].name}: {took}")
        for line in b["log"].splitlines():
            if any(w in line for w in ("registers", "spill", "smem")):
                print(f"    {line.strip()}")
    dumps = [(name, subprocess.Popen(
        [kbuild.cuda_tool("cuobjdump"), "-sass", str(lib["path"])],
        stdout=subprocess.PIPE, text=True))     # all four at once
        for name, lib in (("flash_attention", built[1]),
                          ("ssd_scan", built[2]),
                          ("flash_attention_bwd", built[3]),
                          ("ssd_scan_bwd", built[4]))]
    for name, proc in dumps:
        sass, _ = proc.communicate(timeout=300)
        check(proc.returncode == 0, f"cuobjdump -sass of the {name} library")
        hgmma = sum("HGMMA" in line for line in sass.splitlines())
        check(hgmma > 0, f"the {name} library's SASS has HGMMA instructions")
        say("build", f"{name} SASS: {hgmma} HGMMA (wgmma) instructions")
    SSD_BWD_PTXAS[:] = ptxas_kernels(built[4]["log"])
    for kernel, regs, spills in SSD_BWD_PTXAS:
        say("build", f"ssd_scan_bwd {kernel}: {regs} registers, {spills} "
            "bytes of spill stores and loads")
    for lib, b in (("ssd_scan", built[2]), ("ssd_scan_bwd", built[4])):
        # the f32 CUDA-core kernels spill nothing up to P 64 (P 128: printed)
        for kernel, regs, spills in ptxas_kernels(b["log"]):
            if lib == "ssd_scan":
                say("build", f"ssd_scan {kernel}: {regs} registers, "
                    f"{spills} bytes of spill stores and loads")
            width = re.match(r"ssd_\w+_cc<(\d+), \d+>", kernel)
            if width and int(width.group(1)) <= 64:
                check(spills == 0, f"ptxas spills nothing in {lib} {kernel}")
    for lib, b in (("flash_attention", built[1]),
                   ("flash_attention_bwd", built[3])):
        # the log is empty when an existing build was reused
        for kernel, regs, spills in ptxas_kernels(b["log"]):
            say("build", f"{lib} {kernel}: {regs} registers, {spills} bytes "
                "of spill stores and loads")
            check(spills == 0, f"ptxas spills nothing in {lib} {kernel}")
    if built[3]["log"]:
        for line in built[3]["log"].splitlines():
            if "wgmma.mma_async" in line:   # ptxas's advisories (serialised)
                print(f"    {line.strip()}")
    # every narrow width and the widths past the narrow domain (padded: 4,
    # 20, 100; past 128 the whole-width kernels, and bf16 column slices past
    # 256, 64-row blocks only)
    wider = (4, 20, 100, 136, 192, 256, 264, 512, 520)
    for dtype, rows_ in ((torch.bfloat16, (64, 128)), (torch.float32, (64,))):
        for d in flash_attention.HEAD_DIMS + wider:
            for rows in (rows_ if flash_attention.slices(d, dtype) == 1
                         else (64,)):
                built_bwd = flash_attention.kernel_geometry_bwd(dtype, d, rows)
                mine = flash_attention.geometry_bwd(dtype, d, rows)
                check(built_bwd == mine, f"flash_attention_bwd {dtype} D {d} "
                      f"{rows} rows: the library's other rows, threads and "
                      f"dK/dV and dQ shared memory {built_bwd} == the plan's "
                      f"{mine}")
    for dtype, block_qs in ((torch.bfloat16, (64, 128)), (torch.float32, (64,))):
        for d in flash_attention.HEAD_DIMS + wider:
            for block_q in (block_qs if flash_attention.slices(d, dtype) == 1
                            else (64,)):
                built = flash_attention.kernel_geometry(dtype, d, block_q)
                mine = flash_attention.geometry(dtype, d, block_q)
                check(built == mine, f"flash_attention {dtype} D {d} "
                      f"{block_q} rows: the library's key tile, threads and "
                      f"shared memory {built} == the plan's {mine}")
    for dtype in (torch.bfloat16, torch.float32):
        for p in ssd_scan.HEAD_DIMS:
            for n in ssd_scan.HEAD_DIMS:
                for rows in (64, 128):
                    built = ssd_scan.kernel_geometry(dtype, p, n, rows)
                    mine = ssd_scan.geometry(dtype, p, n, rows)
                    check(built == mine, f"ssd_scan {dtype} P {p} N {n} "
                          f"{rows} rows: the library's threads and shared "
                          f"memory per phase {built} == the plan's {mine}")
    for dtype in (torch.bfloat16, torch.float32):
        for p in ssd_scan.HEAD_DIMS:
            for n in ssd_scan.HEAD_DIMS:
                for rows in (64, 128):
                    built = ssd_scan.kernel_geometry_bwd(dtype, p, n, rows)
                    mine = ssd_scan.geometry_bwd(dtype, p, n, rows)
                    check(built == mine, f"ssd_scan_bwd {dtype} P {p} N {n} "
                          f"{rows} rows: the library's threads and shared "
                          f"memory per launch {built} == the plan's {mine}")


# ------------------------------------------------------------- 2. kernels
def sweep_inputs(b: int, c: int, seed: int):
    g = torch.Generator(device="cuda").manual_seed(seed)
    rem = torch.rand(b, c, device="cuda", generator=g) * 100 + 0.1
    rate = torch.rand(b, c, device="cuda", generator=g) * 5
    rate = torch.where(torch.rand(b, c, device="cuda", generator=g) < 0.1,
                       0.0, rate)
    active = torch.rand(b, c, device="cuda", generator=g) > 0.3
    bound = torch.rand(b, device="cuda", generator=g) * 50 + 0.1
    return rem, rate, active, bound


def call_ms(fn, args, reps: int) -> float:
    """Wall time per call of a loop of calls, enqueue cost included (CUDA
    events around the loop; warm-up excluded)."""
    for _ in range(10):
        fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, args, reps: int) -> float:
    """Device time per call: ``reps`` calls captured in one CUDA graph and
    replayed, so the host's enqueue cost drops out.  Inputs stay the same
    across calls and may sit in the 50 MB L2, as the engine's just-computed
    rates do."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn(*args)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def events_ms(fn, args, reps: int) -> float:
    """Device time per call of calls many milliseconds long: CUDA events
    around ``reps`` eager calls after one warm-up (the enqueue is hidden
    behind the device time)."""
    fn(*args)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sweep_bound_ms(b: int, c: int) -> tuple[float, str]:
    """Least time for the sweep: each input read once and each output
    written once (rem, rate f32, active bool, bound f32 in; rem' and dt f32
    out), or its float32 operations (compare, divide, multiply, subtract,
    max per element), whichever is larger."""
    nbytes = b * c * (4 + 4 + 1 + 4) + b * (4 + 4)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = 5 * b * c / FP32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def phase_sweep_kernel() -> dict:
    record = {}
    for i, (b, c) in enumerate(KERNEL_SHAPES):
        args = sweep_inputs(b, c, seed=i)
        dt, new_rem = vm_update.advance_sweep_cuda(*args)
        dt0, rem0 = ref.advance_sweep_ref(*args)
        torch.cuda.synchronize()
        check(torch.equal(dt, dt0), f"advance_sweep dt bitwise at {(b, c)}")
        check(torch.allclose(new_rem, rem0, rtol=1e-6, atol=1e-5),
              f"advance_sweep rem' within rtol 1e-6/atol 1e-5 at {(b, c)}")
        err = float((new_rem - rem0).abs().max())
        del dt, new_rem, dt0, rem0
        # a graph of the plain version's calls would hold each call's
        # temporaries: shapes of gigabytes are timed eagerly with events
        timer = events_ms if b * c >= 2**28 else device_ms
        reps = 200 if b * c <= 2**22 else 10 if b * c < 2**28 else 3
        # in turns: plain, kernel, kernel, plain
        times = {"plain": [], "kernel": []}
        for name in ("plain", "kernel", "kernel", "plain"):
            fn = ref.advance_sweep_ref if name == "plain" else vm_update.advance_sweep_cuda
            times[name].append(timer(fn, args, reps))
        ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
        per_call = call_ms(vm_update.advance_sweep_cuda, args, reps)
        bound_ms, bound_by = sweep_bound_ms(b, c)
        plan = vm_update.kernel_plan(b, c)
        say("kernels", (
            f"advance_sweep [{b}, {c}] {plan['variant']} "
            f"(threads {plan['threads']}, items {plan['items']}, "
            f"tiles {plan['nb']}): dt bitwise, max|rem' err| {err!r}; "
            f"device time: kernel {ms!r} ms, plain {plain_ms!r} ms; "
            f"kernel per call with its enqueue {per_call!r} ms; "
            f"bytes {b * c * 13 + b * 8}, bound {bound_ms!r} ms ({bound_by}), "
            f"{bound_ms / ms:.3f} of bound"))
        if (b, c) == MAIN_SHAPE:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        del args
        torch.cuda.empty_cache()
    return record


def flash_inputs(shape, dtype, seed: int):
    b, hq, hk, sq, sk, d = shape
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rand(h, s):
        return torch.randn(b, h, s, d, device="cuda", generator=g).to(dtype)

    return rand(hq, sq), rand(hk, sk), rand(hk, sk)


def flash_bound_ms(shape, dtype, kw) -> tuple[float, str, int, int]:
    """Least time for attention: 4 * D operations per valid (query, key)
    pair over the card's peak for the dtype, or q, k, v read once and o
    written once over the memory rate, whichever is larger (the count of
    ``flash_attention.flash_work``, which the dry-run reads too).  Returns
    (ms, what bounds it, operations, bytes)."""
    b, hq, hk, sq, sk, d = shape
    ops, nbytes = flash_attention.flash_work(
        (b, hq, sq, d), (b, hk, sk, d), dtype.itemsize,
        kw.get("causal", True), kw.get("window"))
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    by_ops, by_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    if by_ops >= by_bytes:
        return by_ops, "operations", ops, nbytes
    return by_bytes, "bytes", ops, nbytes


def hold_flash_out(name: str, out: torch.Tensor, want: torch.Tensor,
                   dtype) -> tuple[float, float, float]:
    """The forward kernel's output against the plain version's: elementwise
    within FLASH_TOL, and the relative error of the whole output and of its
    worst row within FLASH_REL_TOL and FLASH_ROW_TOL.  Returns (max |err|,
    relative error, worst row)."""
    err = float((out.float() - want.float()).abs().max())
    tol = FLASH_TOL[dtype]
    check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
          f"flash_attention {name} within {tol}: max |err| {err}")
    diff, norm = out.float() - want.float(), want.float()
    rel = float(diff.norm() / norm.norm())
    row = float((diff.norm(dim=-1)
                 / norm.norm(dim=-1).clamp_min(1e-30)).max())
    check(rel < FLASH_REL_TOL[dtype] and row < FLASH_ROW_TOL[dtype],
          f"flash_attention {name}: relative error {rel} (limit "
          f"{FLASH_REL_TOL[dtype]}), worst row {row} (limit "
          f"{FLASH_ROW_TOL[dtype]})")
    return err, rel, row


def sdpa_kwargs(sq: int, sk: int, kw: dict) -> dict | None:
    """The arguments under which ``scaled_dot_product_attention`` computes
    the kernels' function, or None where it computes another: a softcap it
    does not take, and rows that see no key (Sq > Sk under the causal mask:
    SDPA gives NaN there, the kernels 0).  The kernels align a causal mask
    to the last key; ``causal_lower_right`` does too, and ``is_causal`` (the
    first key) is the same where Sq == Sk.  A sliding window goes in as the
    plain version's boolean mask (``ref.attention_mask``)."""
    if kw.get("softcap"):
        return None
    if kw.get("window") is not None:
        mask = ref.attention_mask(sq, sk, kw.get("causal", True),
                                  kw["window"], "cuda")
        if not bool(mask.any(-1).all()):
            return None
        return {"attn_mask": mask, "enable_gqa": True}
    if not kw.get("causal", True) or sq == sk:
        return {"is_causal": bool(kw.get("causal", True)), "enable_gqa": True}
    if sq < sk:
        return {"attn_mask": causal_lower_right(sq, sk), "enable_gqa": True}
    return None


def library_time(time, backend, named: bool) -> tuple[float | None, str]:
    """SDPA's time by ``time()`` and, where ``named``, the backend it picked
    (``backend()``), as ``(ms, " (backend)")``; where SDPA raises, ``(None,
    " (raised: its error)")``, after a synchronisation that fails the run
    if the error left the card unusable."""
    try:
        ms = time()
        return ms, f" ({backend()})" if named else ""
    except RuntimeError as e:
        torch.cuda.synchronize()
        return None, f" (raised: {str(e).splitlines()[0][:160]})"


def sdpa_backend(fn, args) -> str:
    """The name of the kernel that takes most of one call's device time
    (``torch.profiler``): which of its backends SDPA picked."""
    fn(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn(*args)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0) + e.device_time_total
    return max(by_name, key=by_name.get)[:90] if by_name else "not measured"


def padding_ms(shape, dtype, timer, reps: int,
               backward: bool = False) -> float | None:
    """Device time of the op's layout copies at a width off the multiple of
    8, or None where the width needs none: the forward pads q, k and v with
    zero columns and slices the output back; the backward pads q, k, v, o
    and dO and slices dq, dk and dv back."""
    b, hq, hk, sq, sk, d = shape
    width = flash_attention.padded_width(d)
    if width == d:
        return None
    q, k, v = flash_inputs(shape, dtype, seed=0)
    ins = (q, k, v, q, q) if backward else (q, k, v)
    outs = [torch.empty(*x.shape[:3], width, dtype=dtype, device="cuda")
            for x in ((q, k, v) if backward else (q,))]

    def copies(*_):
        return (flash_attention._pad(width, *ins),
                flash_attention._unpad(d, *outs))

    return timer(copies, (), reps)


def variant_of(shape, dtype) -> str:
    """The plan variant a flash shape must run: the whole-width kernels at
    bf16 padded widths 136-256 and f32 past 128, else the dtype's."""
    if flash_attention.native(shape[-1], dtype):
        return "wgmma_256" if dtype == torch.bfloat16 else "cuda_cores_256"
    return "wgmma" if dtype == torch.bfloat16 else "cuda_cores"


def phase_flash_kernel() -> tuple[dict, dict, dict, dict]:
    """Phase 1's flash shapes; returns the records of FLASH_MAIN, of
    NATIVE_MAIN (the native bf16 kernel), of WIDE_MAIN (the column slices)
    and of F32_MAIN (the f32 whole-width kernel)."""
    record, native_record, wide_record, f32_record = {}, {}, {}, {}
    for i, (name, shape, dtype, kw) in enumerate(FLASH_SHAPES):
        b, hq, hk, sq, sk, d = shape
        args = flash_inputs(shape, dtype, seed=100 + i)
        kernel = functools.partial(flash_attention.flash_attention_cuda, **kw)
        plain = functools.partial(ref.attention_ref, **kw)
        plan = flash_attention.kernel_plan(b, hq, hk, sq, sk, d, dtype, N_SM)
        out, want = kernel(*args), plain(*args)
        torch.cuda.synchronize()
        check(flash_attention.flash_attention_cuda.last_plan == plan,
              f"flash_attention {name} launched its plan")
        check(plan["variant"] == variant_of(shape, dtype),
              f"flash_attention {name}: {plan['variant']} for {dtype}")
        err, rel, row = hold_flash_out(name, out, want, dtype)
        tol = FLASH_TOL[dtype]
        library = sdpa_kwargs(sq, sk, kw)
        if library is not None and "attn_mask" in library:
            # the lower-right or window mask is the kernels': SDPA's output
            # agrees
            lib_out = F.scaled_dot_product_attention(*args, **library)
            check(torch.allclose(lib_out.float(), want.float(), rtol=tol,
                                 atol=tol),
                  f"flash_attention {name}: scaled_dot_product_attention "
                  f"with its mask within {tol} of the plain version")
            del lib_out
        del out, want
        # the plain version holds [B, Hq, Sq, Sk] f32 scores: long calls are
        # timed eagerly with events, short ones by graph replay
        long_call = b * hq * sq * sk >= 2**27
        timer, reps = (events_ms, 3) if long_call else (device_ms, 20)
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kernel
            times[which].append(timer(fn, args, reps))
        ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
        per_call = call_ms(kernel, args, reps)
        library_ms, backend = None, ""
        if library is not None:
            sdpa = functools.partial(F.scaled_dot_product_attention,
                                     **library)
            library_ms, backend = library_time(
                lambda: timer(sdpa, args, reps),
                lambda: sdpa_backend(sdpa, args), name in NAMED_BACKEND)
        pad_ms = padding_ms(shape, dtype, timer, reps)
        bound_ms, bound_by, ops, nbytes = flash_bound_ms(shape, dtype, kw)
        say("kernels", (
            f"flash_attention {name} q [{b}, {hq}, {sq}, {d}] k/v "
            f"[{b}, {hk}, {sk}, {d}] {str(dtype).split('.')[1]} {kw}: "
            f"plan {plan['variant']} (tiles {plan['block_q']} x "
            f"{plan['block_k']}, {plan['threads']} threads, "
            f"{plan['grid'][0] * hq * b} blocks on grid {plan['grid']}, "
            f"{plan['smem']} bytes of shared memory, key split "
            f"{plan['split']}, scratch {plan['scratch']} bytes, width "
            f"{plan['width']}, {plan['slices']} column slices: S formed "
            f"{plan['slices']} times); padding copies {pad_ms!r} ms; "
            f"max |err| {err!r} (tolerance {tol}); relative error {rel!r} "
            f"(limit {FLASH_REL_TOL[dtype]}), worst row {row!r} (limit "
            f"{FLASH_ROW_TOL[dtype]}); device time: kernel "
            f"{ms!r} ms, plain {plain_ms!r} ms, "
            f"scaled_dot_product_attention {library_ms!r} ms{backend}; "
            f"kernel per "
            f"call with its enqueue {per_call!r} ms; {ops} operations, "
            f"{nbytes} bytes, bound {bound_ms!r} ms ({bound_by}), "
            f"{bound_ms / ms:.4f} of bound, {ops / ms / 1e9!r} TFLOP/s"))
        mains = {FLASH_MAIN: record, NATIVE_MAIN: native_record,
                 WIDE_MAIN: wide_record, F32_MAIN: f32_record}
        if name in mains:
            mains[name].update(
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)
        del args
        torch.cuda.empty_cache()
    return record, native_record, wide_record, f32_record


def grad_errors(got: torch.Tensor, want: torch.Tensor
                ) -> tuple[float, float, float]:
    """(max |err| / largest |want|, relative error of the whole tensor,
    worst row's relative error, a row's norm floored at ROW_FLOOR of the
    largest row's)."""
    diff, want = got.float() - want.float(), want.float()
    rows = want.norm(dim=-1)
    floor = rows.clamp_min(ROW_FLOOR * float(rows.max()))
    return (float(diff.abs().max() / want.abs().max()),
            float(diff.norm() / want.norm()),
            float((diff.norm(dim=-1) / floor).max()))


def flash_bwd_bound_ms(shape, dtype, kw) -> tuple[float, str, int, int]:
    """Least time for the backward: five products of 2 * D operations per
    valid (query, key) pair (S, dP, dV, dQ, dK) over the card's peak for the
    dtype, or q, k, v, o, dO read once, lse read once and dq, dk, dv written
    once over the memory rate, whichever is larger (the count of
    ``flash_attention.flash_bwd_work``).  Returns (ms, what bounds it,
    operations, bytes)."""
    b, hq, hk, sq, sk, d = shape
    ops, nbytes = flash_attention.flash_bwd_work(
        (b, hq, sq, d), (b, hk, sk, d), dtype.itemsize,
        kw.get("causal", True), kw.get("window"))
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    by_ops, by_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    if by_ops >= by_bytes:
        return by_ops, "operations", ops, nbytes
    return by_bytes, "bytes", ops, nbytes


def flash_bwd_inputs(name: str, shape, dtype, i: int):
    """q, k, v and dO of backward shape ``i`` (q scaled by
    FLASH_BWD_Q_SCALE)."""
    b, hq, hk, sq, sk, d = shape
    q, k, v = flash_inputs(shape, dtype, seed=300 + i)
    do = flash_inputs((b, hq, hq, sq, sq, d), dtype, seed=400 + i)[0]
    return (q * FLASH_BWD_Q_SCALE.get(name, 1.0)).to(dtype), k, v, do


def phase_flash_bwd_kernel() -> tuple[dict, dict, dict, dict]:
    """The backward kernel against ``ref.attention_bwd_ref`` on the card,
    both from the forward kernel's own output and lse (held against
    ``ref.attention_ref`` and ``ref.attention_lse_ref`` first), at phase
    8b's training shapes and the masking edge cases; two calls bitwise
    equal; a row that sees no key gets exactly zero dq.  Times: the backward, the plain version, the
    forward with and without its lse output, SDPA's backward under
    autograd (where SDPA computes the same function, ``sdpa_kwargs``: no
    window, no softcap, a causal mask through ``causal_lower_right`` where
    Sq < Sk; a window through its mask).  Returns the records of
    FLASH_BWD_MAIN, NATIVE_MAIN (the native bf16 kernels), WIDE_MAIN (the
    column slices) and F32_MAIN (the f32 whole-width kernels)."""
    record, native_record, wide_record, f32_record = {}, {}, {}, {}
    fa = flash_attention
    for i, (name, shape, dtype, kw) in enumerate(FLASH_BWD_SHAPES):
        b, hq, hk, sq, sk, d = shape
        q, k, v, do = flash_bwd_inputs(name, shape, dtype, i)
        plan = fa.kernel_plan_bwd(b, hq, hk, sq, sk, d, dtype, N_SM)
        check(plan["variant"] == variant_of(shape, dtype),
              f"flash_attention_bwd {name}: {plan['variant']} for {dtype}")
        blocks = fa.kernel_block_rows_bwd(b, hq, hk, sq, sk, d, dtype, N_SM)
        check(blocks == (plan["dkdv"]["rows"], plan["dq"]["rows"]),
              f"flash_attention_bwd {name}: the library's dK/dV and dQ block "
              f"rows {blocks} == the plan's")
        out, lse = fa.flash_attention_cuda(q, k, v, return_lse=True, **kw)
        plain_out = fa.flash_attention_cuda(q, k, v, **kw)
        lse0 = ref.attention_lse_ref(q, k, **kw)
        torch.cuda.synchronize()
        check(torch.equal(out, plain_out), f"flash_attention {name}: the "
              "output with lse bitwise the output without")
        # the backward's delta and its plain version both read this output:
        # it is held against the plain forward first
        out_err = hold_flash_out(name, out, ref.attention_ref(q, k, v, **kw),
                                 dtype)
        none = torch.isinf(lse0)
        check(torch.equal(torch.isposinf(lse), none),
              f"flash_attention {name}: lse is +inf exactly on the rows that "
              "see no key")
        lse_err = float((lse[~none] - lse0[~none]).abs().max()) \
            if bool((~none).any()) else 0.0
        check(lse_err <= LSE_TOL, f"flash_attention {name}: lse within "
              f"{LSE_TOL} of the plain version's ({lse_err})")
        grads = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        again = fa.flash_attention_bwd_cuda(q, k, v, out, lse, do, **kw)
        want = ref.attention_bwd_ref(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        check(fa.flash_attention_bwd_cuda.last_plan == plan,
              f"flash_attention_bwd {name} launched its plan")
        check(all(torch.equal(x, y) for x, y in zip(grads, again)),
              f"flash_attention_bwd {name}: two calls bitwise equal")
        hidden = sq - sk if kw.get("causal") and sq > sk else 0
        if hidden:
            check(torch.count_nonzero(grads[0][:, :, :hidden]) == 0,
                  f"flash_attention_bwd {name}: dq exactly zero on the "
                  f"{hidden} rows that see no key")
        errs = {}
        for gname, got, ref_g in zip(("dq", "dk", "dv"), grads, want):
            check(got.dtype == dtype and got.shape == ref_g.shape
                  and bool(got.isfinite().all()),
                  f"flash_attention_bwd {name}: {gname} finite, {dtype}")
            errs[gname] = e = grad_errors(got, ref_g)
            if dtype == torch.float32:
                check(e[0] <= FLASH_BWD_TOL, f"flash_attention_bwd {name}: "
                      f"{gname} within {FLASH_BWD_TOL} of its largest |value|"
                      f" ({e[0]})")
            else:
                check(e[1] < FLASH_BWD_REL_TOL and e[2] < FLASH_BWD_ROW_TOL,
                      f"flash_attention_bwd {name}: {gname} relative error "
                      f"{e[1]} (limit {FLASH_BWD_REL_TOL}), worst row {e[2]} "
                      f"(limit {FLASH_BWD_ROW_TOL})")
        max_abs = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(grads, want))
        del grads, again, want, plain_out, lse0
        torch.cuda.empty_cache()
        args = (q, k, v, out, lse, do)
        kernel = functools.partial(fa.flash_attention_bwd_cuda, **kw)
        plain = functools.partial(ref.attention_bwd_ref, **kw)
        long_call = b * hq * sq * sk >= 2**27
        timer, reps = (events_ms, 3) if long_call else (device_ms, 20)
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kernel
            times[which].append(timer(fn, args, reps))
        ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
        fwd = functools.partial(fa.flash_attention_cuda, **kw)
        fwd_lse = functools.partial(fa.flash_attention_cuda, return_lse=True,
                                    **kw)
        fwd_ms, fwd_lse_ms = (timer(fn, (q, k, v), reps)
                              for fn in (fwd, fwd_lse))
        library_ms, backend = None, ""
        library = sdpa_kwargs(sq, sk, kw)
        if library is not None:
            with torch.enable_grad():
                leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
                graph = {}

                def sdpa_bwd():
                    return torch.autograd.grad(graph["out"], leaves, do,
                                               retain_graph=True)

                def time_bwd():  # the backward alone, of one forward
                    graph["out"] = F.scaled_dot_product_attention(*leaves,
                                                                  **library)
                    return events_ms(sdpa_bwd, (), max(reps, 3))

                library_ms, backend = library_time(
                    time_bwd, lambda: sdpa_backend(sdpa_bwd, ()),
                    name in NAMED_BACKEND)
            del leaves, graph
        pad_ms = padding_ms(shape, dtype, timer, reps, backward=True)
        bound_ms, bound_by, ops, nbytes = flash_bwd_bound_ms(shape, dtype, kw)
        say("kernels", (
            f"flash_attention_bwd {name} q [{b}, {hq}, {sq}, {d}] k/v "
            f"[{b}, {hk}, {sk}, {d}] {str(dtype).split('.')[1]} {kw}: plan "
            f"{plan['variant']} (dK/dV {plan['dkdv']}, dQ {plan['dq']}, grids "
            f"{plan['grids']}, width {plan['width']}, {plan['slices']} column "
            f"slices: S and dP formed {plan['slices']} times); padding "
            f"copies {pad_ms!r} ms; forward "
            f"output (max |err|, relative error, worst row) {out_err} "
            f"(limits {FLASH_TOL[dtype]}, {FLASH_REL_TOL[dtype]}, "
            f"{FLASH_ROW_TOL[dtype]}); lse max |err| "
            f"{lse_err!r}, {int(none.sum())} rows without keys; two calls "
            f"bitwise equal; (max |err| / largest, relative error, worst "
            f"row) {errs}; device time: backward {ms!r} ms, plain "
            f"{plain_ms!r} ms, scaled_dot_product_attention backward "
            f"{library_ms!r} ms{backend}; forward {fwd_ms!r} ms, with lse "
            f"{fwd_lse_ms!r} ms; {ops} operations, {nbytes} bytes, bound "
            f"{bound_ms!r} ms ({bound_by}), {bound_ms / ms:.4f} of bound, "
            f"{ops / ms / 1e9!r} TFLOP/s"))
        mains = {FLASH_BWD_MAIN: record, NATIVE_MAIN: native_record,
                 WIDE_MAIN: wide_record, F32_MAIN: f32_record}
        if name in mains:
            mains[name].update(
                max_abs_err=max_abs, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)
        del q, k, v, do, out, lse, args
        torch.cuda.empty_cache()
    return record, native_record, wide_record, f32_record


def ssd_inputs(shape, dtype, seed: int):
    """Inputs of the size of a Mamba2 layer: dt as softplus gives it at
    init and after some training, A from mamba2's init (-1 .. -16)."""
    b, s, h, p, g, n = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rnd = functools.partial(torch.randn, device="cuda", generator=gen)
    x = (rnd(b, s, h, p) * 0.5).to(dtype)
    dt = torch.rand(b, s, h, device="cuda", generator=gen) * 0.099 + 0.001
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    Bm, Cm = ((rnd(b, s, g, n) * 0.3).to(dtype) for _ in range(2))
    D = torch.rand(h, device="cuda", generator=gen)
    return x, dt, A, Bm, Cm, D


def ssd_bound_ms(shape, dtype, chunk) -> tuple[float, str, int, int]:
    """Least time for the scan: per (b, h) and chunk of q rows (the rows
    this run's S gives it, so a ragged last chunk counts its own),
    q (q + 1) / 2 (N + P) multiply-adds for the causal triangles of C.B^T
    and W x, as flash's bound counts the causal half, and 2 q P N for
    C h_in and the state update, over the card's peak for the dtype; or x,
    dt, B, C read once and y written once over the memory rate, whichever
    is larger (the count of ``ssd_scan.ssd_work``).  Returns (ms, what
    bounds it, operations, bytes)."""
    b, s, h, p, g, n = shape
    ops_, nbytes = ssd_scan.ssd_work((b, s, h, p), g, n, chunk,
                                     dtype.itemsize)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    by_ops, by_bytes = ops_ / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    if by_ops >= by_bytes:
        return by_ops, "operations", ops_, nbytes
    return by_bytes, "bytes", ops_, nbytes


def ssd_phase_ms(by_name: dict, calls: int) -> dict[str, float]:
    """Device ms per call of each ``ssd_fwd*`` and ``ssd_bwd*`` kernel (a
    phase of the bf16 scan, the f32 kernel, a launch of the backward) in a
    profile of ``calls`` calls."""
    phases: dict[str, float] = {}
    for name, (ms, _) in by_name.items():
        found = re.search(r"ssd_(?:fwd|bwd)\w*", name)
        if found:
            key = found.group(0)
            phases[key] = phases.get(key, 0.0) + ms / calls
    return phases


def relative_errors(out, want, dims=(1, 3)) -> tuple[float, float]:
    """The relative error of the whole output and of its worst (b, h) slice
    (``[S, P]`` of y ``[B, S, H, P]``; ``dims=(2, 3)``: ``[P, N]`` of a state
    ``[B, H, P, N]``)."""
    diff, want = out.float() - want.float(), want.float()
    per = diff.norm(dim=dims) / want.norm(dim=dims).clamp_min(1e-30)
    return float(diff.norm() / want.norm()), float(per.max())


def ssd_state_check(name, args, chunk, y, dtype) -> dict:
    """The kernel's final state (``return_state``, the prefill's output)
    against the plain chunked version's over the inputs padded with
    ``dt = 0``: within SSD_TOL[f32] elementwise in f32; in bf16 by the
    relative error of the whole state and of its worst (b, h) slice under
    y's limits.  The y it returns beside the state must be ``y`` bitwise."""
    y_s, state = ssd_scan.ssd_scan_cuda(*args, chunk=chunk, return_state=True)
    _, want = ref.ssd_scan_ref(*args, chunk=chunk, return_state=True)
    torch.cuda.synchronize()
    check(torch.equal(y_s, y), f"ssd_scan {name}: y with the state output "
          "bitwise y without it")
    check(bool(state.isfinite().all()), f"ssd_scan {name}: state finite")
    err = float((state - want).abs().max())
    rel, worst = relative_errors(state, want, dims=(2, 3))
    if dtype == torch.float32:
        tol = SSD_TOL[dtype]
        check(torch.allclose(state, want, rtol=tol, atol=tol),
              f"ssd_scan {name}: final state within {tol} of the chunked "
              f"version: max |err| {err}")
    else:
        check(rel < SSD_REL_TOL[dtype] and worst < SSD_SLICE_TOL[dtype],
              f"ssd_scan {name}: final state relative error {rel} (limit "
              f"{SSD_REL_TOL[dtype]}), worst (b, h) slice {worst} (limit "
              f"{SSD_SLICE_TOL[dtype]})")
    return {"state_max_abs_err": err, "state_rel_err": rel,
            "state_worst_slice_err": worst}


def phase_ssd_kernel() -> dict:
    record = {}
    for i, (name, shape, dtype, chunk, against) in enumerate(SSD_SHAPES):
        b, s, h, p, g, n = shape
        args = ssd_inputs(shape, dtype, seed=200 + i)
        kernel = functools.partial(ssd_scan.ssd_scan_cuda, chunk=chunk)
        plain = functools.partial(ref.ssd_scan_ref, chunk=chunk)
        plan = ssd_scan.kernel_plan(b, s, h, p, g, n, chunk, dtype)
        out = kernel(*args)
        want = (ref.ssd_ref(*args) if against == "sequential"
                else plain(*args))
        torch.cuda.synchronize()
        check(ssd_scan.ssd_scan_cuda.last_plan == plan,
              f"ssd_scan {name} launched its plan")
        check(plan["variant"] == ("wgmma" if dtype == torch.bfloat16
                                  else "cuda_cores"),
              f"ssd_scan {name}: {plan['variant']} for {dtype}")
        nc = -(-s // plan["chunk"])
        if plan["variant"] == "wgmma":
            for ph in (plan["phases"][0], plan["phases"][2]):
                check(ph["grid"] == (nc, *head_grid(h, b)),
                      f"ssd_scan {name}: {ph['name']} launches S/Q x H x B "
                      "blocks")
        else:   # chunk-parallel: a block a (chunk, run of a group's heads, b)
            pw = plan["p_width"]
            tiles = plan["rows"] // 64 * (pw // min(pw, 64))
            runs = head_grid(g * plan["runs"], b)
            check(plan["phases"][0]["grid"] == (nc, *runs)
                  and plan["phases"][2]["grid"] == (nc * tiles, *runs),
                  f"ssd_scan {name}: the f32 phases have a chunk axis")
        check(bool(out.float().isfinite().all()), f"ssd_scan {name} finite")
        err = float((out.float() - want.float()).abs().max())
        tol = SSD_TOL[dtype]
        check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
              f"ssd_scan {name} within {tol} of the {against} version: "
              f"max |err| {err}")
        rel, worst = relative_errors(out, want)
        check(rel < SSD_REL_TOL[dtype] and worst < SSD_SLICE_TOL[dtype],
              f"ssd_scan {name}: relative error {rel} (limit "
              f"{SSD_REL_TOL[dtype]}), worst (b, h) slice {worst} (limit "
              f"{SSD_SLICE_TOL[dtype]})")
        state = ssd_state_check(name, args, chunk, out, dtype)
        del out, want
        if name in SSD_CORNERS:
            say("kernels", (
                f"ssd_scan {name} x [{b}, {s}, {h}, {p}] B/C [{b}, {s}, {g}, "
                f"{n}] {str(dtype).split('.')[1]} chunk {chunk}: plan "
                f"{plan['variant']} (run chunk {plan['chunk']}, P "
                f"{plan['p_slices']} x {plan['p_width']}, N "
                f"{plan['n_slices']} x {plan['n_width']}, "
                f"{plan['launches']} launches, grids "
                f"{[ph['grid'] for ph in plan['phases']]}); max |err| "
                f"{err!r} against the plain version at chunk {chunk} "
                f"(tolerance {tol}); relative error {rel!r}, worst (b, h) "
                f"slice {worst!r}; final state {state}"))
            del args
            continue
        # calls of milliseconds: CUDA events around eager calls, in turns
        with_state = functools.partial(kernel, return_state=True)
        times = {"plain": [], "kernel": [], "state": []}
        for which in ("plain", "kernel", "state", "state", "kernel", "plain"):
            fn = {"plain": plain, "kernel": kernel, "state": with_state}[which]
            times[which].append(events_ms(fn, args, 5))
        ms, plain_ms, state_ms = (sum(times[k]) / 2
                                  for k in ("kernel", "plain", "state"))
        per_call = call_ms(kernel, args, 5)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernel(*args)
            torch.cuda.synchronize()
        phases = ssd_phase_ms(device_time_by_name(prof), 3)
        bound_ms, bound_by, ops_, nbytes = ssd_bound_ms(shape, dtype, chunk)
        steps = ", ".join(
            f"{ph['name']} grid {ph['grid']} x {ph['threads']} threads, "
            f"{ph['smem']} B" for ph in plan["phases"])
        say("kernels", (
            f"ssd_scan {name} x [{b}, {s}, {h}, {p}] B/C [{b}, {s}, {g}, {n}] "
            f"{str(dtype).split('.')[1]} chunk {chunk}: plan {plan['variant']} "
            f"(run chunk {plan['chunk']}, P {plan['p_slices']} x "
            f"{plan['p_width']}, N {plan['n_slices']} x {plan['n_width']}, "
            f"{plan['launches']} launches of: "
            f"tile rows {plan['rows']}; {steps}; scratch "
            f"{plan['scratch_bytes']} B); max |err| {err!r} against the "
            f"{against} version (tolerance {tol}); relative error {rel!r} "
            f"(limit {SSD_REL_TOL[dtype]}), worst (b, h) slice {worst!r} "
            f"(limit {SSD_SLICE_TOL[dtype]}); device time: kernel {ms!r} ms, "
            f"plain {plain_ms!r} ms, kernel with the final state "
            f"{state_ms!r} ms; final state against the chunked version "
            f"{state}; profiled per call {phases}; kernel per "
            f"call with its enqueue {per_call!r} ms; {ops_} operations, "
            f"{nbytes} bytes, bound {bound_ms!r} ms ({bound_by}), "
            f"{bound_ms / ms:.4f} of bound, {ops_ / ms / 1e9!r} TFLOP/s"))
        if name == SSD_MAIN:
            record = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None, "state_ms": state_ms, **state}
        del args
    torch.cuda.empty_cache()

    # gradients: SSDScan (the forward and backward kernels) against
    # autograd through the plain version, f32 at a block of mamba2-130m's
    # widths
    shape = (2, 512, 24, 64, 1, 128)
    args = ssd_inputs(shape, torch.float32, seed=300)
    mine = [a.clone().requires_grad_(True) for a in args]
    theirs = [a.clone().requires_grad_(True) for a in args]
    gy = torch.randn(shape[:4], device="cuda",
                     generator=torch.Generator("cuda").manual_seed(301))
    bwd = ssd_scan.ssd_scan_bwd_cuda.launches
    got = torch.autograd.grad(ops.ssd_scan(*mine, chunk=128), mine, gy)
    check(ssd_scan.ssd_scan_bwd_cuda.launches == bwd + 1,
          "SSDScan's backward launched the backward kernel once")
    want = torch.autograd.grad(ref.ssd_scan_ref(*theirs, chunk=128), theirs,
                               gy)
    worst = {}
    for leaf, a, w in zip(("x", "dt", "A", "Bm", "Cm", "D"), got, want):
        scale = float(w.abs().max())
        worst[leaf] = float((a - w).abs().max()) / scale
        check(bool(a.isfinite().all()) and worst[leaf] <= 1e-4,
              f"SSDScan gradient of {leaf} within 1e-4 of its largest value "
              f"({worst[leaf]!r})")
    say("kernels", f"SSDScan gradients (forward and backward kernels) at x "
        f"{list(shape[:4])} f32 against the plain version's autograd, max "
        f"|err| / max |grad| per leaf: {worst}")
    return record


def ssd_bwd_inputs(shape, dtype, seed: int):
    """``ssd_inputs`` and an output gradient of y's shape."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 1000)
    dy = torch.randn(shape[:4], device="cuda", generator=gen).to(dtype)
    return (*ssd_inputs(shape, dtype, seed), dy)


def ssd_bwd_bound_ms(shape, dtype, chunk) -> tuple[float, str, int, int]:
    """Least time for the backward: per (b, h) and chunk of q rows,
    q (q + 1) / 2 2 P multiply-adds for the causal triangles of dy x^T and
    M^T dy and 5 q P N for the chunk's state and state gradient, B G^T, x G
    and dy h; per (b, g) and chunk q (q + 1) / 2 3 N for those of C B^T,
    dS B and dS^T C (dS summed over the group's heads first); over the
    card's peak for the dtype; or x, dy, dt, B, C read once and dx, ddt,
    dB, dC written once over the memory rate, whichever is larger
    (``ssd_scan.ssd_bwd_work``).
    Returns (ms, what bounds it, operations, bytes)."""
    b, s, h, p, g, n = shape
    ops_, nbytes = ssd_scan.ssd_bwd_work((b, s, h, p), g, n, chunk,
                                         dtype.itemsize)
    peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S
    by_ops, by_bytes = ops_ / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    if by_ops >= by_bytes:
        return by_ops, "operations", ops_, nbytes
    return by_bytes, "bytes", ops_, nbytes


def ssd_bwd_errors(got, want) -> dict[str, tuple]:
    """Per gradient: (max |err| / largest |want|, relative error of the
    whole tensor, of its worst slice or None)."""
    out = {}
    for name, a, w, dims in zip(SSD_BWD_NAMES, got, want,
                                SSD_BWD_SLICE_DIMS):
        diff, w = a.float() - w.float(), w.float()
        worst = None
        if dims is not None:
            worst = float((diff.norm(dim=dims)
                           / w.norm(dim=dims).clamp_min(1e-30)).max())
        out[name] = (float(diff.abs().max() / w.abs().max()),
                     float(diff.norm() / w.norm()), worst)
    return out


def ssd_bwd_failures(errs: dict, dtype) -> list[str]:
    """The limits the gradients break: f32 each within SSD_BWD_TOL of its
    largest value; bf16 each whole and worst slice under its limits."""
    bad = []
    for name, (rel_max, whole, worst) in errs.items():
        if dtype == torch.float32:
            if not rel_max <= SSD_BWD_TOL:
                bad.append(f"{name} max |err| / largest {rel_max} (limit "
                           f"{SSD_BWD_TOL})")
            continue
        if not whole < SSD_BWD_REL_TOL[name]:
            bad.append(f"{name} relative error {whole} (limit "
                       f"{SSD_BWD_REL_TOL[name]})")
        if worst is not None and not worst < SSD_BWD_SLICE_TOL[name]:
            bad.append(f"{name} worst slice {worst} (limit "
                       f"{SSD_BWD_SLICE_TOL[name]})")
    return bad


def ssd_plain_autograd(chunk: int):
    """The backward the card ran before the kernel: autograd through
    ``ref.ssd_scan_ref`` recomputed from the inputs (the plain version the
    kernel is timed against)."""
    def grads(x, dt, A, Bm, Cm, D, dy):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(True)
                      for t in (x, dt, A, Bm, Cm, D)]
            y = ref.ssd_scan_ref(*leaves, chunk=chunk)
            return torch.autograd.grad(y, leaves, dy)
    return grads


def phase_ssd_bwd_kernel() -> dict:
    """The backward kernel against ``ref.ssd_scan_bwd_ref`` at SSD_SHAPES:
    its plan, bitwise equal on a second call, finite, within the limits;
    its device time beside the plain autograd recompute's, the explicit
    plain backward's and the bound, each launch's share from a profiled
    call, the instantiation's registers and spills."""
    record = {}
    for i, (name, shape, dtype, chunk, _) in enumerate(SSD_SHAPES):
        b, s, h, p, g, n = shape
        args = ssd_bwd_inputs(shape, dtype, seed=500 + i)
        plan = ssd_scan.kernel_plan_bwd(b, s, h, p, g, n, chunk, dtype)
        kernel = functools.partial(ssd_scan.ssd_scan_bwd_cuda, chunk=chunk)
        got = kernel(*args)
        again = kernel(*args)
        want = ref.ssd_scan_bwd_ref(*args, chunk=chunk)
        torch.cuda.synchronize()
        check(ssd_scan.ssd_scan_bwd_cuda.last_plan == plan,
              f"ssd_scan_bwd {name} launched its plan")
        check(plan["variant"] == ("wgmma" if dtype == torch.bfloat16
                                  else "cuda_cores"),
              f"ssd_scan_bwd {name}: {plan['variant']} for {dtype}")
        check(all(torch.equal(x, y) for x, y in zip(got, again)),
              f"ssd_scan_bwd {name}: two calls bitwise equal")
        for gname, a, w in zip(SSD_BWD_NAMES, got, want):
            check(a.dtype == w.dtype and a.shape == w.shape
                  and bool(a.isfinite().all()),
                  f"ssd_scan_bwd {name}: {gname} finite, {w.dtype} "
                  f"{tuple(w.shape)}")
        errs = ssd_bwd_errors(got, want)
        bad = ssd_bwd_failures(errs, dtype)
        check(not bad, f"ssd_scan_bwd {name}: {bad}")
        max_abs = max(float((x.float() - y.float()).abs().max())
                      for x, y in zip(got, want))
        del got, again, want
        torch.cuda.empty_cache()
        if name in SSD_CORNERS:
            say("kernels", (
                f"ssd_scan_bwd {name} x [{b}, {s}, {h}, {p}] B/C [{b}, {s}, "
                f"{g}, {n}] {str(dtype).split('.')[1]} chunk {chunk}: plan "
                f"{plan['variant']} (run chunk {plan['chunk']}, P "
                f"{plan['p_slices']} x {plan['p_width']}, N "
                f"{plan['n_slices']} x {plan['n_width']}, "
                f"{plan['launches']} launches); two calls bitwise equal; "
                f"(max |err| / largest, relative error, worst slice) {errs}"))
            del args
            continue
        plain = ssd_plain_autograd(chunk)
        explicit = functools.partial(ref.ssd_scan_bwd_ref, chunk=chunk)
        times = {"plain": [], "kernel": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = plain if which == "plain" else kernel
            times[which].append(events_ms(fn, args, 3))
        ms, plain_ms = (sum(times[k]) / 2 for k in ("kernel", "plain"))
        explicit_ms = events_ms(explicit, args, 3)
        per_call = call_ms(kernel, args, 5)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                kernel(*args)
            torch.cuda.synchronize()
        launches_ms = ssd_phase_ms(device_time_by_name(prof), 3)
        bound_ms, bound_by, ops_, nbytes = ssd_bwd_bound_ms(shape, dtype,
                                                            chunk)
        for launch, launch_ms in launches_ms.items():
            say("kernels", f"ssd_scan_bwd {name} launch {launch}: "
                f"{launch_ms!r} ms a call (profiled); the whole backward "
                f"{ms!r} ms, bound {bound_ms!r} ms, plain {plain_ms!r} ms, "
                f"explicit plain {explicit_ms!r} ms")
        pw, nw = plan["p_width"], plan["n_width"]
        if dtype == torch.bfloat16:
            pp, np_ = (64 if w <= 64 else 128 for w in (pw, nw))
            rows = plan["rows"]
            wgs = plan["phases"][2]["threads"] // 128
            ends = (f"<{pp}, {np_}, {rows}>", f"<{pp}, {np_}, {rows}, {wgs}>",
                    "<bf16>", "<>")
        else:
            ends = (f"<{pw}, {nw}>", "<>", "<f32>")
        regs = [(k, r, sp) for k, r, sp in SSD_BWD_PTXAS if k.endswith(ends)]
        steps = ", ".join(f"{ph['name']} grid {ph['grid']} x "
                          f"{ph['threads']} threads, {ph['smem']} B"
                          for ph in plan["phases"])
        say("kernels", (
            f"ssd_scan_bwd {name} x [{b}, {s}, {h}, {p}] B/C [{b}, {s}, {g}, "
            f"{n}] {str(dtype).split('.')[1]} chunk {chunk}: plan "
            f"{plan['variant']} ({steps}; scratch {plan['scratch_bytes']} "
            f"B); two calls bitwise equal; (max |err| / largest, relative "
            f"error, worst slice) {errs}; device time: backward {ms!r} ms, "
            f"plain (autograd through ssd_scan_ref) {plain_ms!r} ms, "
            f"explicit plain backward {explicit_ms!r} ms; backward per call "
            f"with its enqueue {per_call!r} ms; profiled per call "
            f"{launches_ms}; registers and spill bytes {regs}; {ops_} "
            f"operations, {nbytes} bytes, bound {bound_ms!r} ms "
            f"({bound_by}), {bound_ms / ms:.4f} of bound, "
            f"{ops_ / ms / 1e9!r} TFLOP/s"))
        if name == SSD_MAIN:
            record = {"max_abs_err": max_abs, "ms": ms, "plain_ms": plain_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None, "explicit_plain_ms": explicit_ms}
        del args
        torch.cuda.empty_cache()
    return record


# ------------------------------------------------------------- 3. anchors
def same_as_cpu(gpu_res, scn, name: str) -> None:
    """The card's result against the port's own CPU run of the scenario."""
    agree(gpu_res, simulate(scn, device="cpu"), name)


def agree(gpu_res, cpu_res, name: str) -> None:
    """Integer fields exact, float fields within rtol 1e-5."""
    a, b = result_to_numpy(gpu_res), result_to_numpy(cpu_res)
    for k in a:
        if a[k].dtype.kind in "biu":
            same = (a[k] == b[k]).all()
        else:
            same = (abs(a[k] - b[k]) <= 1e-5 * abs(b[k])).all()
        check(bool(same), f"{name}: field {k} on the card vs the CPU")


def run(scn):
    t0 = time.perf_counter()
    res = simulate(scn)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def phase_anchors() -> tuple[dict, int]:
    """Returns the solo Fig. 9/10 runs (for phase 4) and the batch steps
    (= advance-sweep launches) the phase made."""
    steps = 0
    expected = {
        (SPACE_SHARED, SPACE_SHARED): [400, 400, 800, 800, 1200, 1200, 1600, 1600],
        (SPACE_SHARED, TIME_SHARED): [800] * 4 + [1600] * 4,
        (TIME_SHARED, SPACE_SHARED): [800, 800, 1600, 1600] * 2,
        (TIME_SHARED, TIME_SHARED): [1600] * 8,
    }
    for (hp, vp), finish in expected.items():
        scn = scenarios.fig4_scenario(hp, vp)
        res, secs = run(scn)
        check(res.finish_t.tolist() == [float(x) for x in finish],
              f"fig4 {hp}/{vp} finish times {res.finish_t.tolist()}")
        same_as_cpu(res, scn, f"fig4 {hp}/{vp}")
        steps += int(res.n_events)
        say("anchors", f"fig4 host {hp} / vm {vp}: finish {finish}, "
            f"{int(res.n_events)} events, {secs!r} s")

    scn = scenarios.table1_scenario(True)
    res, secs = run(scn)
    check(int(res.n_finished) == 25 and int(res.n_migrations) == 10,
          f"table1: {int(res.n_finished)} finished, "
          f"{int(res.n_migrations)} migrations")
    same_as_cpu(res, scn, "table1")
    steps += int(res.n_events)
    say("anchors", f"table1 federated: 25 finished, 10 migrations, "
        f"{int(res.n_events)} events, {secs!r} s")

    solo = {}
    for vp in (SPACE_SHARED, TIME_SHARED):
        scn = scenarios.fig9_10_scenario(vp)
        res, secs = run(scn)
        check(int(res.n_finished) == 500, f"fig9_10 vm {vp} finished all")
        if vp == SPACE_SHARED:
            took = res.finish_t - res.start_t
            check(bool(((took - 1200.0).abs() <= 1200.0 * 1e-6).all()),
                  "fig9_10 space-shared tasks take 1200 s")
        same_as_cpu(res, scn, f"fig9_10 vm {vp}")
        steps += int(res.n_events)
        solo[vp] = (scn, res)
        say("anchors", f"fig9_10 10000 hosts, 50 VMs, 500 cloudlets, vm "
            f"policy {vp}: makespan {float(res.makespan)!r} s, mean "
            f"turnaround {float(res.mean_turnaround)!r} s, "
            f"{int(res.n_events)} events, {secs!r} s")

    scn = scenarios.fig7_8_scenario(100_000)
    res, secs = run(scn)
    check(int(res.n_finished) == 1 and bool(res.vm_placed.all()),
          "fig7_8 at 100000 hosts")
    same_as_cpu(res, scn, "fig7_8")
    steps += int(res.n_events)
    say("anchors", f"fig7_8 100000 hosts: {int(res.n_events)} events, "
        f"{secs!r} s")
    return solo, steps


# ------------------------------------------------------------ 4. campaign
def phase_campaign(solo: dict) -> tuple[int, object, object]:
    rows = [solo[SPACE_SHARED][0], solo[TIME_SHARED][0]] * (CAMPAIGN_ROWS // 2)
    batch = stack_scenarios(rows)
    mib = sum(x.numel() * x.element_size() for x in batch.leaves()) / 2**20
    syncs0 = step.host_any.syncs
    res, secs = run(batch)
    syncs = step.host_any.syncs - syncs0
    events = res.n_events
    batch_steps = int(events.max())
    check(bool((res.n_finished == 500).all()), "campaign rows finish all")
    for i, vp in enumerate((SPACE_SHARED, TIME_SHARED)):
        a = result_to_numpy(res.map(lambda x: x[i]))
        b = result_to_numpy(solo[vp][1])
        for k in a:
            check(a[k].shape == b[k].shape and (a[k] == b[k]).all(),
                  f"campaign row {i} field {k} bitwise its solo run")
    say("campaign", (
        f"{CAMPAIGN_ROWS} x fig9_10 (10000 hosts, vm policy alternating), "
        f"scenario {mib:.1f} MiB on the card: wall {secs!r} s, "
        f"{batch_steps} batch steps, {int(events.sum())} row events, "
        f"{batch_steps / secs!r} batch steps/s, "
        f"{int(events.sum()) / secs!r} row events/s, "
        f"{syncs} host syncs = {syncs / batch_steps!r} per batch step; "
        "rows 0 and 1 bitwise their solo runs"))
    return batch_steps, batch, res


# ---------------------------------------------------------- 4b. extensions
def bitwise(a_res, b_res, what: str) -> None:
    a, b = result_to_numpy(a_res), result_to_numpy(b_res)
    for k in a:
        check(a[k].shape == b[k].shape and (a[k] == b[k]).all(),
              f"{what}: field {k} bitwise")


def gen(seed: int) -> torch.Generator:
    """The port's generators draw from a CPU generator: a scenario built
    for the card equals the one built for the CPU from the same seed."""
    return torch.Generator().manual_seed(seed)


def ext_anchors() -> int:
    """(a) Each extension constructor on the card against the port's CPU
    run, with its anchor.  Returns the batch steps."""
    steps = 0

    def card(name, scn, instrumented=False):
        nonlocal steps
        t0 = time.perf_counter()
        res, out = simulate_instrumented(scn)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        same_as_cpu(res, scn, name)
        steps += int(res.n_events)
        say("extensions", f"{name}: {int(res.n_finished)} of "
            f"{scn.cloudlets.n_cloudlets} finished, {int(res.n_events)} "
            f"events, {int(res.n_migrations)} migrations, "
            f"{int(res.n_evacuations)} evacuations, {int(res.sla_violations)}"
            f" SLA violations, downtime {float(res.downtime)!r} s, makespan "
            f"{float(res.makespan)!r} s, energy "
            f"{float(res.energy_j.sum())!r} J, outputs "
            f"{ {k: {n: v.tolist() for n, v in o.items()} for k, o in out.items()} }, "
            f"{secs!r} s")
        return (res, out) if instrumented else res

    evac = card("evacuation", scenarios.evacuation_scenario())
    check(int(evac.sla_violations) == 0 and int(evac.n_evacuations) == 2,
          "evacuation: 0 SLA violations, 2 evacuations")
    ctrl = card("restart-from-zero control", scenarios.evacuation_scenario(
        evacuation=False, ckpt_interval=INF))
    check(int(ctrl.sla_violations) == 2 and float(ctrl.downtime) > 0,
          "restart control: 2 SLA violations, downtime > 0")
    on = card("consolidation", scenarios.consolidation_scenario())
    off = card("consolidation, static control",
               scenarios.consolidation_scenario(live_migration=False))
    check(float(on.energy_j.sum()) < float(off.energy_j.sum()),
          "consolidation: less energy with migration than without")
    on = card("balance", scenarios.balance_scenario())
    off = card("balance, static control",
               scenarios.balance_scenario(live_migration=False))
    check(float(on.makespan) < float(off.makespan),
          "balance: makespan with migration under the static control's")
    res = card("table1 with live migration",
               scenarios.table1_scenario(True, live_migration=True))
    check(int(res.n_finished) == 25, "table1 live migration finishes all")
    (on, out_on), (off, out_off) = (
        card(f"autoscale {flag} (torch seed 0)", scenarios.autoscale_scenario(
            gen(0), autoscale=flag == "on"), instrumented=True)
        for flag in ("on", "off"))
    check(int(on.n_finished) == int(off.n_finished) == 48,
          "autoscale on and off finish all 48 cloudlets")
    check(int(out_off["autoscale"]["n_scale_up"]) == 0,
          "autoscale off never scales")
    rel = card("reliability (torch seed 0)", scenarios.reliability_scenario(
        gen(0), mtbf_s=300.0))
    check(int(rel.n_finished) == 8, "reliability finishes all 8 cloudlets")
    never = scenarios.reliability_scenario(gen(0), mtbf_s=INF)
    res = card("reliability, MTBF = INF control", never)
    plain = simulate(never.replace(outages=None, instruments=()))
    bitwise(res, plain, "MTBF = INF control vs the scenario without outages")
    steps += int(plain.n_events)
    for kind in ("poisson", "diurnal", "bursty"):
        res = card(f"generated {kind} (torch seed 0)",
                   scenarios.generated_scenario(gen(0), kind=kind))
        check(int(res.n_finished) == 64, f"generated {kind} finishes all")
    res = card("serving (torch seed 0)", scenarios.serving_scenario(gen(0)))
    check(int(res.n_finished) == 64, "serving finishes all 64 requests")
    return steps


def ext_traces(solo: dict, campaign) -> int:
    """(b) ``simulate_trace`` at Fig. 9/10's 10,000 hosts and over phase
    4's campaign.  Returns the batch steps."""
    scn, res = solo[SPACE_SHARED]
    ts = torch.linspace(0.0, 7_000.0, TRACE_SAMPLES)
    t0 = time.perf_counter()
    res_t, prog = simulate_trace(scn, ts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bitwise(res_t, res, "fig9_10 traced vs untraced on the card")
    steps = int(res_t.n_events)
    _, prog_cpu = simulate_trace(scn, ts, device="cpu")
    a, b = prog.cpu().numpy(), prog_cpu.numpy()
    check(a.shape == (TRACE_SAMPLES, 500), f"trace shape {a.shape}")
    check(bool((abs(a - b) <= 1e-5 * abs(b)).all()),
          "fig9_10 trace progress within rtol 1e-5 of the CPU trace")
    say("extensions", f"simulate_trace fig9_10 10000 hosts, {TRACE_SAMPLES} "
        f"samples: result bitwise the untraced run, progress max |card - cpu|"
        f" {float(abs(a - b).max())!r}, {secs!r} s")
    batch, batch_res = campaign
    t0 = time.perf_counter()
    res_c, prog_c = simulate_trace(batch, ts)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    bitwise(res_c, batch_res, "traced campaign vs untraced campaign")
    check(tuple(prog_c.shape) == (CAMPAIGN_ROWS, TRACE_SAMPLES, 500),
          f"campaign trace shape {tuple(prog_c.shape)}")
    steps += int(res_c.n_events.max())
    say("extensions", f"simulate_trace of the {CAMPAIGN_ROWS}-row campaign: "
        f"result bitwise the untraced campaign, progress "
        f"{tuple(prog_c.shape)}, wall {secs!r} s, "
        f"{int(res_c.n_events.max())} batch steps, "
        f"{int(res_c.n_events.sum()) / secs!r} row events/s")
    return steps


def reliability_campaign(rows: int):
    """``rows`` reliability rows on the card: row i is grid point i % 16
    (MTBF x policy) with the outage draws of seed i // 16, so each MTBF
    scales the same unit draws.  The template and the per-row schedules
    and policies go through ``broadcast_campaign``; row i equals
    ``reliability_scenario(gen(i // 16), mtbf_s=..., evacuation=...,
    ckpt_interval=..., **RELIABILITY)``."""
    grid = [(m, e, c) for m in RELIABILITY_MTBFS
            for e, c in RELIABILITY_POLICIES]
    template = scenarios.reliability_scenario(None, **RELIABILITY)
    shape = tuple(template.outages.fail_t.shape)
    draws = [workload.host_outages(gen(i // len(grid)), *shape,
                                   grid[i % len(grid)][0], 400.0,
                                   device="cpu") for i in range(rows)]
    outages = Outages(
        fail_t=torch.stack([o.fail_t for o in draws]).to("cuda"),
        repair_t=torch.stack([o.repair_t for o in draws]).to("cuda"))
    policy = template.policy.map(lambda x: x.expand(rows).clone()).replace(
        evacuation=torch.tensor([grid[i % len(grid)][1] for i in range(rows)],
                                device="cuda"),
        ckpt_interval=torch.tensor([grid[i % len(grid)][2]
                                    for i in range(rows)], device="cuda"))
    batch = broadcast_campaign(template, rows, outages=outages, policy=policy)
    mtbf, evac, ckpt = grid[1]
    one = scenarios.reliability_scenario(
        gen(0), mtbf_s=mtbf, evacuation=evac, ckpt_interval=ckpt,
        **RELIABILITY)
    check(all(torch.equal(a, b) for a, b in zip(
        scenario_row(batch, 1).leaves(), one.leaves())),
        "reliability campaign row 1 is reliability_scenario's")
    return batch, grid


def campaign_run(name: str, batch, phase: str = "extensions") -> tuple:
    """A stacked campaign on the card through ``simulate_instrumented``.
    Returns (result, batch steps)."""
    mib = sum(x.numel() * x.element_size() for x in batch.leaves()) / 2**20
    rows = batch.policy.horizon.shape[0]
    syncs0 = step.host_any.syncs
    t0 = time.perf_counter()
    res, out = simulate_instrumented(batch)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    syncs = step.host_any.syncs - syncs0
    steps = int(res.n_events.max())
    events = int(res.n_events.sum())
    summary = {k: {n: float(v.float().mean()) for n, v in o.items()}
               for k, o in out.items()}
    say(phase, (
        f"{name}: {rows} rows, scenario {mib:.1f} MiB on the card: wall "
        f"{secs!r} s, {steps} batch steps, {events} row events, "
        f"{events / secs!r} row events/s, {steps / secs!r} batch steps/s, "
        f"{syncs} host syncs = {syncs / steps!r} per batch step, mean "
        f"finished {float(res.n_finished.float().mean())!r}, mean outputs "
        f"{summary}"))
    return res, steps


def solo_rows(name: str, batch, res, check_rows,
              phase: str = "extensions") -> int:
    """Each of ``check_rows`` bitwise its solo run on the card, which
    equals the port's CPU run.  Returns the solo runs' batch steps."""
    steps = 0
    for i in check_rows:
        scn = scenario_row(batch, i)
        t0 = time.perf_counter()
        solo, _ = simulate_instrumented(scn)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        bitwise(res.map(lambda x: x[i]), solo,
                f"{name} row {i} vs its solo run on the card")
        t0 = time.perf_counter()
        same_as_cpu(solo, scn, f"{name} row {i}")
        steps += int(solo.n_events)
        say(phase, f"{name}: row {i} ({int(solo.n_events)} events) "
            f"bitwise its solo run on the card ({card_s!r} s), which equals "
            f"the CPU's ({time.perf_counter() - t0!r} s)")
    return steps


def profile_window(batch, first: int, count: int) -> dict:
    """Batch steps ``first .. first + count`` of the campaign, stepped as
    ``engine.simulate`` steps it, under ``torch.profiler``: kernel launches
    per batch step, the device's idle share in the window, and the host
    time inside ``provision.provision_due_vms`` (its share of the window's
    wall)."""
    ctx, aux = step.make_context(batch)
    max_steps = step.resolve_max_steps(batch, ctx.instruments)
    carry = (engine.init_state(batch), aux)
    provisioning = [0.0, 0]
    place = provision.provision_due_vms

    def timed_place(scn, st):
        t0 = time.perf_counter()
        out = place(scn, st)
        provisioning[0] += time.perf_counter() - t0
        provisioning[1] += 1
        return out

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    taken, prof, wall = 0, None, 0.0
    while taken < first + count:
        live = step.step_cond(batch, carry[0], max_steps)
        if not step.host_any(live):
            break
        if taken == first:
            torch.cuda.synchronize()
            provision.provision_due_vms = timed_place
            prof = torch.profiler.profile(activities=acts)
            prof.start()
            t0 = time.perf_counter()
        carry, _, _ = step.batch_event_step(batch, carry, ctx, live)
        taken += 1
    torch.cuda.synchronize()
    check(prof is not None and taken == first + count,
          f"the profiled window reached batch step {first + count}")
    wall = time.perf_counter() - t0
    prof.stop()
    provision.provision_due_vms = place
    kernels = [a for a in prof.key_averages()
               if a.device_type == torch.autograd.DeviceType.CUDA]
    device_s = sum(a.self_device_time_total for a in kernels) / 1e6
    launches = sum(a.count for a in kernels)
    return {"steps": taken, "launches_per_step": launches / count,
            "idle_share": 1.0 - device_s / wall, "wall_s": wall,
            "device_s": device_s, "provision_s": provisioning[0],
            "provision_calls": provisioning[1],
            "provision_share": provisioning[0] / wall}


def phase_extensions(solo: dict, campaign) -> int:
    """Returns the batch steps (= advance-sweep launches) of the phase."""
    took, t0 = {}, time.perf_counter()
    steps = ext_anchors()
    took["anchors"] = time.perf_counter() - t0
    steps += ext_traces(solo, campaign)
    took["traces"] = time.perf_counter() - t0 - sum(took.values())

    # (c) reliability at Fig. 9/10's scale
    batch, grid = reliability_campaign(RELIABILITY_ROWS)
    name = (f"reliability campaign (MTBF 3e5/1e6/1e7/INF x evacuation x "
            f"ckpt INF/600 s, {RELIABILITY_ROWS // len(grid)} seeds; 10000 "
            "hosts, 50 VMs, 500 cloudlets)")
    res, batch_steps = campaign_run(name, batch)
    steps += batch_steps
    point = torch.arange(RELIABILITY_ROWS, device="cuda") % len(grid)
    for g, (mtbf, evac, ckpt) in enumerate(grid):
        sel = point == g
        say("extensions", (
            f"reliability MTBF {mtbf:g} s, evacuation {evac}, ckpt "
            f"{ckpt:g} MI: mean events {float(res.n_events[sel].float().mean())!r}, "
            f"evacuations {float(res.n_evacuations[sel].float().mean())!r}, "
            f"migrations {float(res.n_migrations[sel].float().mean())!r}, "
            f"downtime {float(res.downtime[sel].mean())!r} s, SLA "
            f"violations {float(res.sla_violations[sel].float().mean())!r}, "
            f"makespan {float(res.makespan[sel].mean())!r} s"))
    # two MTBF 1e6 rows that met a failure: one evacuated, one evicted and
    # restarted (its makespan passed the 12,000 s of work)
    mid = point // len(RELIABILITY_POLICIES) == 1
    evacuated = mid & (res.n_evacuations > 0)
    restarted = mid & ~batch.policy.evacuation & (res.makespan > 12_000.5)
    check(bool(evacuated.any() and restarted.any()),
          "the MTBF 1e6 rows met failures: evacuations and restarts")
    steps += solo_rows(name, batch, res, (
        int(evacuated.nonzero()[0]), int(restarted.nonzero()[0])))
    win = profile_window(batch, PROFILED_FROM, PROFILED_STEPS)
    steps += win["steps"]
    say("extensions", (
        f"reliability campaign, batch steps {PROFILED_FROM}-"
        f"{PROFILED_FROM + PROFILED_STEPS} profiled: "
        f"{win['launches_per_step']!r} kernel launches per batch step, idle "
        f"share {win['idle_share']!r} (device {win['device_s']!r} s of "
        f"{win['wall_s']!r} s), provisioning loop {win['provision_calls']} "
        f"calls, {win['provision_s']!r} s of host time = share "
        f"{win['provision_share']!r}"))
    del batch
    took["reliability campaign"] = time.perf_counter() - t0 - sum(took.values())

    # (d) the repo's own campaign surfaces
    rates, ups = np.linspace(0.05, 0.2, 8), np.linspace(0.3, 1.0, 8)
    batch = stack_scenarios([scenarios.autoscale_scenario(
        gen(i // 64), burst_rate=float(rates[i % 8]),
        scale_up_thresh=float(ups[i // 8 % 8]), max_steps=800, device="cpu")
        for i in range(CAMPAIGN_ROWS)]).to("cuda")
    name = "autoscale campaign (burst rate x scale-up threshold x 16 seeds)"
    res, batch_steps = campaign_run(name, batch)
    check(bool((res.n_finished == 48).all()), "autoscale rows finish all")
    steps += batch_steps + solo_rows(name, batch, res, (0, CAMPAIGN_ROWS - 1))
    template = scenarios.consolidation_scenario()
    cons, bals = np.linspace(0.0, 0.9, 32), np.linspace(0.5, 2.0, 32)
    i = np.arange(CAMPAIGN_ROWS)
    policy = template.policy.map(
        lambda x: x.expand(CAMPAIGN_ROWS).clone()).replace(
        migrate_consolidate_thresh=torch.tensor(
            cons[i % 32], dtype=torch.float32, device="cuda"),
        migrate_balance_thresh=torch.tensor(
            bals[i // 32 % 32], dtype=torch.float32, device="cuda"))
    batch = broadcast_campaign(template, CAMPAIGN_ROWS, policy=policy)
    name = "consolidation campaign (consolidate x balance thresholds)"
    res, batch_steps = campaign_run(name, batch)
    check(bool((res.n_finished == 4).all()), "consolidation rows finish all")
    steps += batch_steps + solo_rows(name, batch, res, (1, CAMPAIGN_ROWS - 2))
    took["autoscale and consolidation campaigns"] = (
        time.perf_counter() - t0 - sum(took.values()))
    say("timing", "extensions: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in took.items()))
    return steps


# -------------------------------------------------- 4c. network and campaigns
class BatchSteps:
    """Counts the engine's batch steps on the card: installed in place of
    ``engine.batch_event_step``, which every driver (``simulate`` and its
    kin, ``run_campaign``'s chunks, the search's rungs) calls once a step."""

    def __init__(self):
        self.n = 0
        self.inner = engine.batch_event_step

    def __call__(self, scn_b, carry, ctx, live):
        if scn_b.hosts.cores.is_cuda:
            self.n += 1
        return self.inner(scn_b, carry, ctx, live)


def timed(fn, *args, **kw):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def prebound_staging(device=None) -> Scenario:
    """Two fixed-binding cloudlets staging 1,000 MB each from DC1 to DC0
    over one 100 Mbps link, submitted at 0 and 2 s: the second opens at a
    ``K_STAGE`` clock stop, and fair sharing starts them at 18 and 20 s."""
    hosts = scenarios.uniform_hosts(2, 2, cores=1, mips=100.0, ram_mb=4096.0,
                                    device=device)
    vms = scenarios.uniform_vms(2, dc=0, cores=1, mips=100.0, ram_mb=256.0,
                                device=device)
    cls = scenarios.make_cloudlets(
        np.arange(2), np.full(2, 100.0), np.array([0.0, 2.0]),
        input_mb=1000.0, output_mb=0.0, input_dc=1, device=device)
    return Scenario(hosts=hosts, vms=vms, cloudlets=cls,
                    market=scenarios.uniform_market(2, device=device),
                    policy=scenarios.make_policy(horizon=1e6, device=device),
                    topology=Topology.uniform(2, latency_s=0.0, bw_mbps=100.0,
                                              device=device))


def net_anchors(solo: dict) -> None:
    """(a) The topology on the card against the CPU and the flat runs."""
    def card(name, scn):
        res, secs = timed(simulate, scn)
        same_as_cpu(res, scn, name)
        say("network", f"{name}: {int(res.n_finished)} of "
            f"{scn.cloudlets.n_cloudlets} finished, {int(res.n_events)} "
            f"events, {int(res.n_migrations)} migrations, makespan "
            f"{float(res.makespan)!r} s, mean turnaround "
            f"{float(res.mean_turnaround)!r} s, equals the CPU's, {secs!r} s")
        return res

    for loc in (False, True):
        res = card(f"staging_scenario, locality dispatch {loc}",
                   scenarios.staging_scenario(locality_dispatch=loc))
        check(int(res.n_finished) == 48, "staging finishes all 48")
    # the reference's lock holds where no two transfers share a link:
    # Table 1 with 8 VMs overflows one VM (its 25 VMs move 10 at once)
    single = scenarios.table1_scenario(True, n_vms=8)
    for name, scn, flat in (("table1, 8 VMs", single, simulate(single)),
                            ("fig9_10 10000 hosts", solo[SPACE_SHARED][0],
                             solo[SPACE_SHARED][1])):
        topo = Topology.uniform(scn.hosts.n_dc, latency_s=0.0, bw_mbps=float(
            scn.policy.interdc_bw_mbps))
        res, secs = timed(simulate, scn.replace(topology=topo))
        bitwise(res, flat, f"{name} under a neutral topology vs flat")
        say("network", f"{name} under a neutral topology (uniform "
            f"{float(scn.policy.interdc_bw_mbps)!r} Mbps, latency 0): "
            f"bitwise the flat run on the card, {secs!r} s")
    table1 = scenarios.table1_scenario(True)
    res = card("table1 over Topology.from_coordinates", table1.replace(
        topology=Topology.from_coordinates(COORDS_KM)))
    check(int(res.n_finished) == 25 and int(res.n_migrations) == 10,
          "table1 from coordinates: 25 finished, 10 migrations")
    evac = scenarios.evacuation_scenario()
    res = card("evacuation under Topology.uniform(2, 0.05 s, 100 Mbps)",
               evac.replace(topology=Topology.uniform(2, latency_s=0.05,
                                                      bw_mbps=100.0)))
    flat = simulate(evac)
    check(int(res.n_evacuations) == 2 and int(res.sla_violations) == 0,
          "evacuation under a topology: 2 evacuations, no SLA violation")
    check(bool((res.finish_t > flat.finish_t).all()),
          "the two evacuations share their link: later than the flat run")
    for name, scn, ts in (
            ("table1 federated energy", table1.replace(
                power=PowerModel.uniform(3), topology=Topology.uniform(
                    3, latency_s=5.0, bw_mbps=50.0)),
             torch.linspace(0.0, 9_000.0, TRACE_SAMPLES)),
            ("fig9_10 10000 hosts federated energy", solo[SPACE_SHARED][0]
             .replace(power=PowerModel.uniform(1), topology=Topology.uniform(
                 1, latency_s=5.0, bw_mbps=50.0)),
             torch.linspace(0.0, 7_000.0, TRACE_SAMPLES))):
        (res, prog), secs = timed(simulate_trace, scn, ts)
        res_cpu, prog_cpu = simulate_trace(scn, ts, device="cpu")
        agree(res, res_cpu, f"{name} traced")
        a, b = prog.cpu().numpy(), prog_cpu.numpy()
        check(bool((abs(a - b) <= 1e-5 * abs(b)).all()),
              f"{name}: progress within rtol 1e-5 of the CPU trace")
        check(float(res.energy_j.sum()) > 0, f"{name}: energy accrued")
        say("network", f"simulate_trace {name}, {TRACE_SAMPLES} samples: "
            f"result and progress equal the CPU's (max |card - cpu| "
            f"{float(abs(a - b).max())!r}), {int(res.n_events)} events, "
            f"{secs!r} s")
    scn = prebound_staging()
    res, hist = simulate_history(scn)
    same_as_cpu(res, scn, "pre-bound staging")
    valid = hist.valid
    kinds, t = hist.kind[valid], hist.t[valid]
    _, hist_cpu = simulate_history(scn, device="cpu")
    check(torch.equal(hist.kind.cpu(), hist_cpu.kind),
          "pre-bound staging history kinds equal the CPU's")
    check(int((kinds == step.K_STAGE).sum()) == 1
          and float(t[kinds == step.K_STAGE][0]) == 2.0,
          "one K_STAGE event, at t = 2 s")
    check(res.start_t.tolist() == [18.0, 20.0],
          f"fair-shared starts {res.start_t.tolist()} == [18, 20]")
    say("network", f"simulate_history of a pre-bound staging pair: kinds "
        f"{kinds.tolist()}, one K_STAGE at 2 s, starts 18 and 20 s")


def staging_campaign(rows: int):
    """``rows`` staging rows on the card: row i is grid point i % 24 with
    the i // 24-th wave spacing.  The per-row cloudlet inputs and submit
    times, link rates and locality flags go through ``broadcast_campaign``
    over one template; row i equals ``staging_scenario(**STAGING,
    input_mb=..., bw_mbps=..., latency_s=..., locality_dispatch=...,
    wave_dt=...)``."""
    dts = np.linspace(0.5, 60.0, -(-rows // len(STAGING_GRID)))
    point = [STAGING_GRID[i % len(STAGING_GRID)] for i in range(rows)]
    wave_dt = [float(dts[i // len(STAGING_GRID)]) for i in range(rows)]
    mb, bw, lat, loc = (np.array(x) for x in zip(*point))
    n_dc, n_cl = STAGING["n_dc"], STAGING["n_cloudlets"]
    template = scenarios.staging_scenario(**STAGING)
    # the constructor's float64 arithmetic, then float32, as it rounds it
    waves = np.arange(n_cl) // STAGING["wave"]
    submit = (waves[None, :] * np.array(wave_dt)[:, None]).astype(np.float32)

    def on(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device="cuda")

    cls = template.cloudlets.map(lambda x: x.expand((rows,) + tuple(x.shape)))
    cls = cls.replace(
        input_mb=on(np.broadcast_to(mb[:, None], (rows, n_cl))),
        submit_t=on(submit)).map(torch.clone)
    policy = template.policy.map(lambda x: x.expand(rows).clone()).replace(
        interdc_bw_mbps=on(bw), locality_dispatch=on(loc, torch.bool))
    off_diag = on(1 - np.eye(n_dc))
    topology = Topology(
        latency_s=on(lat)[:, None, None] * off_diag,
        bw_mbps=on(bw)[:, None, None].expand(rows, n_dc, n_dc).clone())
    batch = broadcast_campaign(template, rows, cloudlets=cls, policy=policy,
                               topology=topology)
    mb1, bw1, lat1, loc1 = point[1]
    one = scenarios.staging_scenario(
        **STAGING, input_mb=mb1, bw_mbps=bw1, latency_s=lat1,
        locality_dispatch=loc1, wave_dt=wave_dt[1])
    check(all(torch.equal(a, b) for a, b in zip(
        scenario_row(batch, 1).leaves(), one.leaves())),
        "staging campaign row 1 is staging_scenario's")
    return batch


def stream_campaign(rows: int):
    """``rows`` Fig. 9/10 rows at 10,000 hosts held on the host: a vm
    policy (space / time shared) x seed grid, each seed drawing the row's
    cloudlet length scale (0.8-1.2) and CPU price (2-4 per second)."""
    template = scenarios.fig9_10_scenario(SPACE_SHARED, device="cpu")
    g = gen(17)
    scale = (0.8 + 0.4 * torch.rand(rows // 2, generator=g)).repeat_interleave(2)
    price = (2.0 + 2.0 * torch.rand(rows // 2, generator=g)).repeat_interleave(2)
    cls = template.cloudlets.map(lambda x: x.expand((rows,) + tuple(x.shape)))
    cls = cls.replace(length_mi=cls.length_mi * scale[:, None])
    mkt = template.market.map(lambda x: x.expand((rows,) + tuple(x.shape)))
    mkt = mkt.replace(cost_per_cpu_sec=price[:, None].clone())
    policy = template.policy.map(lambda x: x.expand(rows).clone()).replace(
        vm_policy=torch.tensor([SPACE_SHARED, TIME_SHARED] * (rows // 2),
                               dtype=torch.int32))
    return broadcast_campaign(template, rows, cloudlets=cls.map(torch.clone),
                              market=mkt.map(torch.clone), policy=policy)


def stream_reducers(n: int) -> dict:
    return {"events": SumReducer("n_events"),
            "finished": SumReducer("n_finished"),
            "turnaround": MeanReducer("mean_turnaround"),
            "makespan": HistogramReducer("makespan", 0.0, 20_000.0, bins=64),
            "best": ArgBestReducer("total_cost"),
            "cost": ValuesReducer("total_cost", n_slots=n)}


def summary_leaves(x) -> list:
    if isinstance(x, dict):
        return [t for k in sorted(x) for t in summary_leaves(x[k])]
    if hasattr(x, "leaves"):
        return x.leaves()
    return [x]


def mem_mark() -> int:
    """Reset the card's peak-memory counter; returns the bytes allocated
    now (what earlier phases still hold)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gib(base: int) -> float:
    """GiB of the peak since ``mem_mark`` above what was allocated then."""
    return (torch.cuda.max_memory_allocated() - base) / 2**30


def phase_network(solo: dict) -> int:
    """Returns the batch steps (= advance-sweep launches) of the phase."""
    counter = BatchSteps()
    engine.batch_event_step = counter
    try:
        took, t0 = {}, time.perf_counter()
        net_anchors(solo)
        took["anchors"] = time.perf_counter() - t0

        # (b) the staging campaign
        batch = staging_campaign(STAGING_ROWS)
        name = (f"staging campaign (8 DCs x 125 hosts, 128 VMs, 512 "
                f"cloudlets in waves of 64; input MB x Mbps x latency x "
                f"locality, {-(-STAGING_ROWS // len(STAGING_GRID))} wave "
                "spacings)")
        base = mem_mark()
        res, secs = timed(campaign_run, name, batch, "network")
        res, batch_steps = res
        over = " (over the 60 s budget: cut rows)" if secs > 60 else ""
        check(bool((res.n_finished == STAGING["n_cloudlets"]).all()),
              "staging rows finish all")
        say("network", f"staging campaign: peak memory {peak_gib(base)!r} "
            f"GiB above the {base / 2**30!r} GiB held before, "
            f"wall {secs!r} s{over}, events per row min "
            f"{int(res.n_events.min())} max {int(res.n_events.max())}")
        solo_rows("staging campaign", batch, res, (0, 1), phase="network")
        win = profile_window(batch, STAGING_PROFILED_FROM,
                             STAGING_PROFILED_STEPS)
        say("network", (
            f"staging campaign, batch steps {STAGING_PROFILED_FROM}-"
            f"{STAGING_PROFILED_FROM + STAGING_PROFILED_STEPS} profiled: "
            f"{win['launches_per_step']!r} kernel launches per batch step, "
            f"idle share {win['idle_share']!r} (device {win['device_s']!r} s "
            f"of {win['wall_s']!r} s)"))
        del batch, res
        took["staging campaign"] = (time.perf_counter() - t0
                                    - sum(took.values()))

        # (c) the streamed Fig. 9/10 campaign, held on the host
        batch = stream_campaign(STREAM_ROWS)
        outs = {}
        for chunk in STREAM_CHUNKS:
            base = mem_mark()
            steps0, syncs0 = counter.n, step.host_any.syncs
            out, secs = timed(run_campaign, batch, chunk_size=chunk,
                              reduce=stream_reducers(STREAM_ROWS))
            steps = counter.n - steps0
            events = int(out["events"])
            outs[chunk] = out
            check(int(out["finished"]) == 500 * STREAM_ROWS,
                  f"streamed chunk {chunk}: every row finishes all")
            say("network", (
                f"streamed {STREAM_ROWS} x fig9_10 (10000 hosts) from the "
                f"host, chunk {chunk}: wall {secs!r} s, {steps} batch steps, "
                f"{events} row events, {events / secs!r} row events/s, "
                f"{(step.host_any.syncs - syncs0) / steps!r} host syncs per "
                f"batch step, peak memory {peak_gib(base)!r} GiB above the "
                f"{base / 2**30!r} GiB held before; mean turnaround "
                f"{float(out['turnaround']['mean'])!r} s, makespan q0.5 "
                f"{float(out['makespan']['q0.5'])!r} s, best total cost "
                f"{float(out['best']['value'])!r} at row "
                f"{int(out['best']['index'])}"))
        a, b = (outs[c] for c in STREAM_CHUNKS)
        for key in ("events", "finished", "makespan", "best", "cost"):
            for x, y in zip(summary_leaves(a[key]), summary_leaves(b[key])):
                check(torch.equal(x, y), f"streamed {key} bitwise across "
                      "chunk sizes")
        for k in ("n", "mean", "std"):
            x, y = float(a["turnaround"][k]), float(b["turnaround"][k])
            check(abs(x - y) <= 1e-5 * abs(y),
                  f"streamed mean turnaround {k} within rtol 1e-5")
        first = batch.map(lambda x: x[:STREAM_CHUNKS[0]])
        base = mem_mark()
        res, secs = timed(simulate, first)
        say("network", (
            f"materialised {STREAM_CHUNKS[0]} x fig9_10 from the host: wall "
            f"{secs!r} s, {int(res.n_events.max())} batch steps, "
            f"{int(res.n_events.sum()) / secs!r} row events/s, peak memory "
            f"{peak_gib(base)!r} GiB above the {base / 2**30!r} GiB held "
            "before"))
        first = first.to("cuda")
        n = STREAM_CHUNKS[0]
        index = torch.arange(n, dtype=torch.int32, device="cuda")
        valid = torch.ones(n, dtype=torch.bool, device="cuda")
        streamed = run_campaign(first, chunk_size=n,
                                reduce=stream_reducers(STREAM_ROWS))
        for key, r in stream_reducers(STREAM_ROWS).items():
            folded = r.finalize(r.fold(r.init(first, res), first, res, index,
                                       valid))
            for x, y in zip(summary_leaves(folded),
                            summary_leaves(streamed[key])):
                check(torch.equal(x, y), f"chunk 0's {key} fold bitwise the "
                      "fold of its materialised result")
        say("network", f"streamed folds: integer sums, histogram, ArgBest "
            f"and Values bitwise across chunks of {STREAM_CHUNKS[0]} and "
            f"{STREAM_CHUNKS[1]}, means within rtol 1e-5; chunk 0's folds "
            "bitwise the fold of its materialised result")
        del batch, first, res
        took["streamed campaign"] = (time.perf_counter() - t0
                                     - sum(took.values()))

        # (d) successive halving over Table 1, card against CPU
        steps0 = counter.n
        out, secs = timed(search.successive_halving,
                          scenarios.table1_scenario(True), HALVING_SPACE,
                          generator=gen(5), **HALVING)
        cpu = search.successive_halving(
            scenarios.table1_scenario(True, device="cpu"), HALVING_SPACE,
            generator=gen(5), device="cpu", **HALVING)
        for i, (r, c) in enumerate(zip(out["rungs"], cpu["rungs"])):
            check(torch.equal(r["candidates"], c["candidates"]),
                  f"rung {i} candidates equal the CPU's")
            x, y = r["values"].cpu().numpy(), c["values"].numpy()
            check(bool((abs(x - y) <= 1e-5 * abs(y)).all()),
                  f"rung {i} values within rtol 1e-5 of the CPU's")
        check(out["best_index"] == cpu["best_index"],
              "successive halving's winner equals the CPU's")
        say("network", (
            f"successive_halving over table1, n0 {HALVING['n0']}, rungs "
            f"{[int(r['candidates'].shape[0]) for r in out['rungs']]} at "
            f"horizons {list(HALVING['fidelities'])}: winner "
            f"{out['best_index']} ({ {k: v.item() for k, v in out['best_params'].items()} }), "
            f"mean turnaround {float(out['best_value'])!r} s, equal to the "
            f"CPU's; {counter.n - steps0} batch steps, wall {secs!r} s"))
        took["successive halving"] = (time.perf_counter() - t0
                                      - sum(took.values()))
        say("timing", "network and campaigns: " + ", ".join(
            f"{k} {v:.1f} s" for k, v in took.items()))
        return counter.n + win["steps"]
    finally:
        engine.batch_event_step = counter.inner


# ------------------------------------------------------------- 6. serving
def serve_once(model, params, prompts,
               new_tokens: int = SERVE_NEW_TOKENS) -> tuple[ServingEngine, float]:
    eng = ServingEngine(model, params, **SERVE)
    for p in prompts:
        eng.submit(p, max_new_tokens=new_tokens)
    t0 = time.perf_counter()
    eng.run_until_drained()
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def phase_serving() -> int:
    """Returns the flash kernel's launches over the counted run."""
    cfg = get_config(SERVE_ARCH)
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(x.numel() for x in tree.leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n))
               for n in rng.integers(128, 513, size=SERVE_REQUESTS)]

    # a first run under the profiler warms up and gives the device time
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, traced_wall = serve_once(model, params, prompts)
    by_name = device_time_by_name(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    flash_ms = sum(ms for name, (ms, _) in by_name.items()
                   if "flash_fwd" in name)
    share = (f"{flash_ms / busy_ms!r} ({flash_ms!r} ms of {busy_ms!r} "
             f"ms device time; idle share {1 - busy_ms / 1e3 / traced_wall!r}"
             f" of the traced wall {traced_wall!r} s)" if busy_ms > 0
             else "not measured")
    say("serving", f"traced run: {sum(n for _, n in by_name.values())} "
        f"device activities, {busy_ms!r} ms device time; the most:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:10.3f} ms  {n:6d} launches  {name[:100]}")

    # the counted run
    torch.cuda.reset_peak_memory_stats()
    flash_attention.flash_attention_cuda.launches = 0
    vm_update.advance_sweep_cuda.launches = 0
    eng, wall = serve_once(model, params, prompts)
    flash_launches = flash_attention.flash_attention_cuda.launches
    sweep_launches = vm_update.advance_sweep_cuda.launches
    st = eng.stats
    check(all(r.done and r.generated == SERVE_NEW_TOKENS
              for r in eng.requests), "every request served its 32 tokens")
    check(flash_launches == cfg.n_layers * st["prefills"],
          f"flash launches {flash_launches} == {cfg.n_layers} layers x "
          f"{st['prefills']} prefills")
    check(sweep_launches > 0, "the re-plans launched the advance sweep")
    peak = torch.cuda.max_memory_allocated() / 2**30
    say("serving", (
        f"{SERVE_ARCH} full width and depth ({cfg.n_layers} layers, "
        f"{n_params} parameters, f32 weights, bf16 compute, init {init_s!r} "
        f"s): {len(prompts)} requests, prompts {[len(p) for p in prompts]}, "
        f"{SERVE_NEW_TOKENS} new tokens each, {SERVE}: wall {wall!r} s, "
        f"{eng.steps} engine steps, {st['prefills']} prefills of "
        f"{st['prefill_tokens']} tokens in {st['prefill_s']!r} s = "
        f"{st['prefill_tokens'] / st['prefill_s']!r} prefill tokens/s, "
        f"{st['decode_steps']} decode steps of {st['decode_tokens']} tokens "
        f"in {st['decode_s']!r} s = {st['decode_tokens'] / st['decode_s']!r} "
        f"decode tokens/s; final policy {eng.sched.policy}; flash kernel "
        f"{flash_launches} launches, advance sweep {sweep_launches} launches "
        f"(re-plans); flash share of device time {share}; peak memory "
        f"{peak!r} GiB"))
    del eng
    torch.cuda.empty_cache()
    long_prefill(model, params, cfg)
    del params
    torch.cuda.empty_cache()
    return flash_launches


def long_prefill(model, params, cfg) -> None:
    """One ``Model.prefill`` of a single LONG_PROMPT-token prompt at full
    width and depth: a first run under the profiler gives flash's share of
    the device time, a second one, timed on the host clock, tokens/s."""
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab, size=(1, LONG_PROMPT))).cuda()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            logits, _ = model.prefill(params, {"tokens": prompt}, LONG_PROMPT)
            torch.cuda.synchronize()
        check(logits.shape == (1, cfg.vocab)
              and bool(logits.float().isfinite().all()),
              f"long prefill logits {tuple(logits.shape)} finite")
        launches = flash_attention.flash_attention_cuda.launches
        t0 = time.perf_counter()
        logits, _ = model.prefill(params, {"tokens": prompt}, LONG_PROMPT)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = flash_attention.flash_attention_cuda.launches - launches
    check(launches == cfg.n_layers, f"long prefill: {launches} flash "
          f"launches == {cfg.n_layers} layers")
    by_name = device_time_by_name(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    flash_ms = sum(ms for name, (ms, _) in by_name.items()
                   if "flash_fwd" in name)
    share = (f"{flash_ms / busy_ms!r} ({flash_ms!r} ms of {busy_ms!r} ms "
             "device time in the profiled run)" if busy_ms > 0
             else "not measured")
    say("serving", f"long prefill, profiled run: {busy_ms!r} ms device "
        "time; the most:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        print(f"    {ms:10.3f} ms  {n:6d} launches  {name[:100]}")
    say("serving", f"{SERVE_ARCH} full width and depth, one Model.prefill of "
        f"{LONG_PROMPT} tokens (bf16): wall {wall!r} s = "
        f"{LONG_PROMPT / wall!r} prefill tokens/s, {launches} flash "
        f"launches; flash share of device time {share}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB")


# ----------------------------------------------------------- 6b. model zoo
def kernel_classes(by_name: dict) -> dict[str, list]:
    """Device ms and launches of a profile's kernels by what they do: the
    port's kernels, the matrix products, the MoE dispatch (index and
    scatter ops, sorts; the index class also holds embedding rows), the
    bf16 casts of the f32 weights, other copies (cache writes, layouts),
    reductions, other elementwise kernels, and the rest."""
    out: dict[str, list] = {}
    for name, (ms, n) in by_name.items():
        low = name.lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in low for k in keys)), "other")
        acc = out.setdefault(cls, [0.0, 0])
        acc[0] += ms
        acc[1] += n
    return out


def profile_report(phase: str, prof, wall: float, top: int = 8) -> str:
    """Prints the profile's kernels by class and the most expensive ones;
    returns the idle share of ``wall``."""
    by_name = device_time_by_name(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    classes = {c: [round(ms, 3), n] for c, (ms, n) in sorted(
        kernel_classes(by_name).items(), key=lambda kv: -kv[1][0])}
    idle = (f"{1 - busy_ms / 1e3 / wall!r}" if busy_ms > 0
            else "not measured")
    say(phase, f"traced run: {sum(n for _, n in by_name.values())} device "
        f"activities, {busy_ms!r} ms device time, idle share {idle} of the "
        f"traced wall {wall!r} s; by class [ms, launches] {classes}; the "
        "most:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]:
        print(f"    {ms:10.3f} ms  {n:6d} launches  {name[:100]}")
    return idle


class PlainSSDOnCard:
    """Counts calls of the SSD's plain versions (the chunked scan
    ``ref.ssd_chunked_ref``, which ``ssd_scan_ref`` runs, and the plain
    backward ``ref.ssd_scan_bwd_ref``) on a CUDA tensor while it is
    entered: a prefill and a training step must launch the kernels."""

    NAMES = ("ssd_chunked_ref", "ssd_scan_bwd_ref")

    def __enter__(self):
        self.calls = 0
        self.inner = {name: getattr(ref, name) for name in self.NAMES}

        def counting(inner):
            def call(x, *args, **kw):
                self.calls += int(x.is_cuda)
                return inner(x, *args, **kw)
            return call

        for name, inner in self.inner.items():
            setattr(ref, name, counting(inner))
        return self

    def __exit__(self, *exc):
        for name, inner in self.inner.items():
            setattr(ref, name, inner)


class PlainAttentionOnCard(PlainSSDOnCard):
    """The same count for the flash kernels' plain versions."""

    NAMES = ("attention_ref", "attention_lse_ref", "attention_bwd_ref")


def zero_launches() -> None:
    for fn in (flash_attention.flash_attention_cuda, ssd_scan.ssd_scan_cuda,
               vm_update.advance_sweep_cuda,
               flash_attention.flash_attention_bwd_cuda,
               ssd_scan.ssd_scan_bwd_cuda):
        fn.launches = 0
    for fn in (flash_attention.flash_attention_cuda,
               flash_attention.flash_attention_bwd_cuda):
        fn.native_launches = fn.wide_launches = fn.padded_launches = 0


def launches() -> dict[str, int]:
    return {"flash": flash_attention.flash_attention_cuda.launches,
            "ssd": ssd_scan.ssd_scan_cuda.launches,
            "sweep": vm_update.advance_sweep_cuda.launches,
            "flash_bwd": flash_attention.flash_attention_bwd_cuda.launches,
            "ssd_bwd": ssd_scan.ssd_scan_bwd_cuda.launches}


def mixers(cfg, kind: str) -> int:
    return cfg.n_periods * sum(cfg.mixer_kind(i) == kind
                               for i in range(cfg.period))


def zoo_model(arch: str, n_layers: int | None = None):
    """(cfg, model, f32 parameters on the card from seed 0, init seconds),
    from an emptied cache with the peak-memory count reset."""
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.synchronize()
    return cfg, model, params, time.perf_counter() - t0


def zoo_serve(arch: str, n_layers: int | None, n_requests: int,
              new_tokens: int) -> None:
    """(a), (b): ``ServingEngine`` as phase 6 drives it, a profiled run
    first, then the counted one."""
    cfg, model, params, init_s = zoo_model(arch, n_layers)
    n_params = sum(x.numel() for x in tree.leaves(params))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=int(n))
               for n in rng.integers(128, 513, size=n_requests)]
    label = "zoo " + arch
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, traced_wall = serve_once(model, params, prompts, new_tokens)
    idle = profile_report(label, prof, traced_wall)
    del prof
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with PlainSSDOnCard() as plain:
        eng, wall = serve_once(model, params, prompts, new_tokens)
    count = launches()
    st = eng.stats
    check(all(r.done and r.generated == new_tokens for r in eng.requests),
          f"{arch}: every request served its {new_tokens} tokens")
    n_attn, n_ssm = mixers(cfg, "attn"), mixers(cfg, "ssm")
    check(count["flash"] == n_attn * st["prefills"],
          f"{arch}: flash launches {count['flash']} == {n_attn} attention "
          f"layers x {st['prefills']} prefills")
    check(count["ssd"] == n_ssm * st["prefills"],
          f"{arch}: SSD launches {count['ssd']} == {n_ssm} SSM layers x "
          f"{st['prefills']} prefills")
    check(plain.calls == 0, f"{arch}: the plain chunked SSD ran "
          f"{plain.calls} times on the card")
    check(count["sweep"] > 0, f"{arch}: the re-plans launched the advance "
          "sweep")
    peak = torch.cuda.max_memory_allocated() / 2**30
    cut = (f"depth cut to {cfg.n_layers} layers (one period)"
           if n_layers is not None else "full width and depth")
    say(label, (
        f"{cut}: {cfg.n_layers} layers ({n_attn} attention, {n_ssm} SSM, "
        f"{sum(cfg.mlp_kind(i) == 'moe' for i in range(cfg.period)) * cfg.n_periods}"
        f" MoE), {n_params} parameters, f32 weights, bf16 compute, init "
        f"{init_s!r} s: {len(prompts)} requests, prompts "
        f"{[len(p) for p in prompts]}, {new_tokens} new tokens each, "
        f"{SERVE}: wall {wall!r} s, {eng.steps} engine steps, "
        f"{st['prefills']} prefills of {st['prefill_tokens']} tokens in "
        f"{st['prefill_s']!r} s = {st['prefill_tokens'] / st['prefill_s']!r} "
        f"prefill tokens/s, {st['decode_steps']} decode steps of "
        f"{st['decode_tokens']} tokens in {st['decode_s']!r} s = "
        f"{st['decode_tokens'] / st['decode_s']!r} decode tokens/s; "
        f"launches {count}; plain chunked SSD on the card {plain.calls}; "
        f"idle share of the traced run {idle}; peak memory {peak!r} GiB"))
    del eng, params
    torch.cuda.empty_cache()


def greedy_run(model, params, batch: dict, max_len: int, steps: int,
               start: int, tokens: list | None = None):
    """``Model.prefill`` of ``batch`` then ``steps`` greedy decode steps
    from position ``start`` (fed ``tokens[i]``, ``[B, 1]``, instead of its
    own pick at step i where given): (each step's logits, the caches,
    prefill seconds, decode seconds, flash launches of the prefill, of the
    decode steps)."""
    flash = flash_attention.flash_attention_cuda
    dev = batch["tokens"].device
    before = flash.launches
    t0 = time.perf_counter()
    logits, caches = model.prefill(params, batch, max_len)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    prefill_s, mid = time.perf_counter() - t0, flash.launches
    out = [logits]

    def pick(i: int, lg):
        return lg.argmax(-1)[:, None] if tokens is None else tokens[i].to(dev)

    tok = pick(0, logits)
    pos = torch.full((tok.shape[0],), start, device=dev)
    t1 = time.perf_counter()
    for i in range(steps):
        logits, caches = model.decode_step(params, caches, tok, pos)
        out.append(logits)
        if i + 1 < steps:
            tok = pick(i + 1, logits)
        pos = pos + 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return (out, caches, prefill_s, time.perf_counter() - t1,
            mid - before, flash.launches - mid)


def zoo_generate(label: str, cfg, model, params, batch: dict, max_len: int,
                 steps: int, start: int, prefill_flash: int,
                 step_flash: int) -> None:
    """(c), (d): a profiled run, then a timed one with its flash launches
    counted per prefill and per decode step; the peak memory is theirs,
    not the initialisation's."""
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            greedy_run(model, params, batch, max_len, steps, start)
            traced_wall = time.perf_counter() - t0
        idle = profile_report(label, prof, traced_wall)
        del prof
        zero_launches()
        out, _, prefill_s, decode_s, pre, dec = greedy_run(
            model, params, batch, max_len, steps, start)
    B = batch["tokens"].shape[0]
    check(all(lg.shape == (B, cfg.vocab) and bool(lg.isfinite().all())
              for lg in out), f"{label}: logits finite, [{B}, {cfg.vocab}]")
    check(pre == prefill_flash, f"{label}: prefill flash launches {pre} == "
          f"{prefill_flash}")
    check(dec == step_flash * steps, f"{label}: decode flash launches {dec} "
          f"== {step_flash} x {steps} steps")
    check(launches()["ssd"] == 0, f"{label}: no SSD launch")
    say(label, (
        f"prefill {prefill_s!r} s ({pre} flash launches), {steps} greedy "
        f"decode steps of {B} tokens in {decode_s!r} s = "
        f"{B * steps / decode_s!r} decode tokens/s ({dec} flash launches, "
        f"{dec // max(steps, 1)} a step); idle share of the traced run "
        f"{idle}; peak memory {torch.cuda.max_memory_allocated() / 2**30!r} "
        "GiB"))


def mrope_positions(n_patch: int, grid: int, n_text: int, device=None):
    """``[3, 1, n_patch + n_text]``: the patches at t = 0, h = i // grid,
    w = i % grid; the text at ``n_patch // grid + j`` on all three."""
    i = torch.arange(n_patch, device=device)
    patch = torch.stack([torch.zeros_like(i), i // grid, i % grid])
    text = (n_patch // grid + torch.arange(n_text, device=device)).expand(3, -1)
    return torch.cat([patch, text], 1)[:, None]


def phase_zoo() -> None:
    """6b: the MoE, hybrid, encoder-decoder and vlm families on the card."""
    took = {}
    t0 = time.perf_counter()
    for arch, n_layers, n_requests, new_tokens in ZOO_SERVE:
        zoo_serve(arch, n_layers, n_requests, new_tokens)
        took[arch] = time.perf_counter() - t0 - sum(took.values())

    cfg, model, params, _ = zoo_model("whisper-large-v3")
    B, P, steps = WHISPER["batch"], WHISPER["prompt"], WHISPER["steps"]
    gen = torch.Generator(device="cuda").manual_seed(1)
    batch = {"frames": torch.randn(B, cfg.encoder.n_ctx, cfg.d_model,
                                   device="cuda", generator=gen),
             "tokens": torch.from_numpy(np.random.default_rng(1).integers(
                 0, cfg.vocab, size=(B, P))).cuda()}
    zoo_generate(
        f"zoo whisper-large-v3 (full width and depth, {B} x "
        f"{cfg.encoder.n_ctx} frames, {P}-token prompt)", cfg, model, params,
        batch, P + steps, steps, P,
        cfg.encoder.n_layers + 2 * cfg.n_layers, cfg.n_layers)
    del params, batch
    took["whisper-large-v3"] = time.perf_counter() - t0 - sum(took.values())

    n_patch, n_text = VLM["patches"], VLM["text"]
    cfg, model, params, _ = zoo_model("qwen2-vl-72b", VLM["n_layers"])
    gen = torch.Generator(device="cuda").manual_seed(2)
    batch = {"frontend_embeds": torch.randn(1, n_patch, cfg.d_model,
                                            device="cuda", generator=gen),
             "tokens": torch.from_numpy(np.random.default_rng(2).integers(
                 0, cfg.vocab, size=(1, n_text))).cuda(),
             "positions": mrope_positions(n_patch, VLM["grid"], n_text,
                                          "cuda")}
    S = n_patch + n_text
    zoo_generate(
        f"zoo qwen2-vl-72b (full width, depth cut to {cfg.n_layers} layers, "
        f"{n_patch} patch embeddings + {n_text} tokens, M-RoPE positions)",
        cfg, model, params, batch, S + VLM["steps"], VLM["steps"], S,
        mixers(cfg, "attn"), 0)
    del params, batch
    torch.cuda.empty_cache()
    took["qwen2-vl-72b"] = time.perf_counter() - t0 - sum(took.values())
    say("timing", "model zoo: " + ", ".join(f"{k} {v:.1f} s"
                                            for k, v in took.items()))


# -------------------------------------------------------------- 7. parity
def host_copy(params):
    return tree.map_tree(lambda t: t.cpu(), params)


def hold_logits(label: str, runs: dict, upto: int | None = None):
    """Each step's logits on the card within atol/rtol 1e-3 of the CPU's,
    and the same greedy tokens, over the first ``upto`` steps (all by
    default): (max |logit err|, [(CPU tokens, smallest top-1 margin)])."""
    worst, tokens = 0.0, []
    for i, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if upto is not None and i >= upto:
            break
        check(torch.allclose(a, b, atol=1e-3, rtol=1e-3),
              f"{label} parity step {i}: logits within 1e-3 (max |err| "
              f"{float((a - b).abs().max())})")
        check(torch.equal(a.argmax(-1), b.argmax(-1)),
              f"{label} parity step {i}: greedy token")
        worst = max(worst, float((a - b).abs().max()))
        top2 = b.topk(2, -1).values
        tokens.append((b.argmax(-1).tolist(),
                       float((top2[:, 0] - top2[:, 1]).min())))
    return worst, tokens


def parity_runs(model, cpu, gpu, batch: dict, max_len: int, steps: int,
                start: int, around=contextlib.nullcontext):
    """``greedy_run`` on the CPU and on the card from the same parameters
    and batch, each inside a fresh ``around()``: ({device: each step's
    logits on the host}, {device: the caches}, {device: what ``around()``
    entered as})."""
    runs, caches, entered = {}, {}, {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        b = {k: v.to(dev) for k, v in batch.items()}
        with torch.no_grad(), around() as entered[dev]:
            out, caches[dev], *_ = greedy_run(model, params, b, max_len,
                                              steps, start)
        runs[dev] = [lg.cpu() for lg in out]
    return runs, caches, entered


def phase_parity() -> None:
    """The card against the port's CPU run at full width, f32, for
    internlm2-1.8b (2 layers) and the phase 6b families.  The kernel adds
    the keys of a row in another order than the plain version (tiles of
    64, FMAs), and cuBLAS the products of the matmuls: differences of ~1e-6
    relative per layer, far inside 1e-3 on logits of order 1, and too small
    to swap the greedy token (its margin over the runner-up is printed)."""
    cfg = dataclasses.replace(get_config(SERVE_ARCH, dtype="float32"),
                              n_layers=2)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(1))
    gpu = tree.map_tree(lambda t: t.to("cuda"), cpu)
    prompt = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 200)))
    runs, _, _ = parity_runs(model, cpu, gpu, {"tokens": prompt}, 256, 8,
                             200)
    worst, tokens = hold_logits(SERVE_ARCH, runs)
    say("parity", (
        f"{SERVE_ARCH} full width, 2 layers, f32: prefill of 200 tokens and "
        f"8 greedy decode steps on the card equal the CPU run: max |logit "
        f"err| {worst!r}, tokens and CPU top-1 margins {tokens}"))
    del cpu, gpu
    parity_moe()
    parity_whisper()
    parity_vlm()
    parity_jamba_ssm()
    torch.cuda.empty_cache()


class RouteLog:
    """Records, while entered, each ``moe._route`` call's chosen experts and
    its f32 router probabilities (recomputed beside the call)."""

    def __enter__(self):
        self.calls, self.inner = [], moe._route

        def recording(xt, router, E, K):
            out = self.inner(xt, router, E, K)
            probs = torch.softmax(xt.float() @ router.float(), dim=-1)
            self.calls.append((out[1].cpu(), probs.cpu()))
            return out

        moe._route = recording
        return self

    def __exit__(self, *exc):
        moe._route = self.inner


def parity_moe() -> None:
    """granite-moe at full width, 2 layers, f32.  The routing is compared
    first: where the card and the CPU choose another expert set for a
    token, the gap between its K-th and (K+1)-th probability (on the CPU)
    must be f32 noise (at most 1e-5); such a tie is printed, and the logits
    are held only over the steps before it (the runs take other experts
    from there on)."""
    cfg = dataclasses.replace(
        get_config("granite-moe-1b-a400m", dtype="float32"), n_layers=2)
    model = build_model(cfg)
    gpu = model.init(torch.Generator(device="cuda").manual_seed(5))
    cpu = host_copy(gpu)
    prompt = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, size=(1, 200)))
    steps = 8
    runs, _, logs = parity_runs(model, cpu, gpu, {"tokens": prompt}, 256,
                                steps, 200, around=RouteLog)
    calls = {dev: log.calls for dev, log in logs.items()}
    n_moe, K = cfg.n_layers, cfg.moe.top_k
    check(len(calls["cpu"]) == len(calls["cuda"]) == n_moe * (steps + 1),
          f"granite parity: {len(calls['cuda'])} routing calls == {n_moe} "
          f"MoE layers x {steps + 1} steps")
    tie = None
    for j, ((ids_c, probs), (ids_g, _)) in enumerate(zip(calls["cpu"],
                                                          calls["cuda"])):
        rows = (ids_c.sort(-1).values != ids_g.sort(-1).values).any(-1)
        if not bool(rows.any()):
            continue
        top = probs[rows].sort(-1, descending=True).values
        gap = float((top[:, K - 1] - top[:, K]).max())
        check(gap <= 1e-5, f"granite parity: routing call {j} (step "
              f"{j // n_moe}, layer {j % n_moe}) chose other experts for "
              f"{int(rows.sum())} tokens at a probability gap of {gap}")
        tie = (j // n_moe, j % n_moe, int(rows.sum()), gap)
        break
    held = steps + 1 if tie is None else tie[0]
    worst, tokens = hold_logits("granite-moe", runs, held)
    routing = ("the same experts in every call" if tie is None else
               f"a tie at step {tie[0]}, layer {tie[1]}: {tie[2]} tokens "
               f"at a probability gap of {tie[3]!r}")
    logits = (f"no step's logits held (the tie is in the prefill)"
              if held == 0 else
              f"the logits of {held} of {steps + 1} steps (prefill of 200 "
              f"tokens, then greedy decode) equal the CPU run: max |logit "
              f"err| {worst!r}, tokens and CPU top-1 margins {tokens}")
    say("parity", (
        f"granite-moe-1b-a400m full width, 2 layers, f32, card against the "
        f"CPU: routing {routing}; {logits}"))
    del cpu, gpu


def parity_whisper() -> None:
    """whisper at full width, 2 encoder + 2 decoder layers, f32: the prefill
    logits and its cross K/V caches, then 8 greedy decode steps."""
    full = get_config("whisper-large-v3", dtype="float32")
    cfg = dataclasses.replace(
        full, n_layers=2, encoder=dataclasses.replace(full.encoder,
                                                      n_layers=2))
    model = build_model(cfg)
    gpu = model.init(torch.Generator(device="cuda").manual_seed(6))
    cpu = host_copy(gpu)
    rng = np.random.default_rng(6)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
                 (1, cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(1, 32)))}
    runs, caches, _ = parity_runs(model, cpu, gpu, batch, 48, 8, 32)
    cross = {}
    for name in ("ck", "cv"):
        a, b = caches["cuda"][name].cpu(), caches["cpu"][name]
        cross[name] = float((a - b).abs().max())
        check(torch.allclose(a, b, atol=1e-3, rtol=1e-3),
              f"whisper parity: {name} within 1e-3 ({cross[name]})")
    worst, tokens = hold_logits("whisper", runs)
    say("parity", (
        f"whisper-large-v3 full width, 2 + 2 layers, f32, {cfg.encoder.n_ctx} "
        f"frames and a 32-token prompt: the prefill, its cross K/V (max "
        f"|err| {cross}) and 8 greedy decode steps on the card equal the CPU "
        f"run: max |logit err| {worst!r}, tokens and CPU top-1 margins "
        f"{tokens}"))
    del cpu, gpu


def parity_vlm() -> None:
    """qwen2-vl at full width, 1 layer, f32: 16 patch embeddings (a 4 x 4
    grid) and 16 tokens with M-RoPE positions, prefill and 4 decode
    steps."""
    cfg = dataclasses.replace(get_config("qwen2-vl-72b", dtype="float32"),
                              n_layers=1)
    model = build_model(cfg)
    gpu = model.init(torch.Generator(device="cuda").manual_seed(7))
    cpu = host_copy(gpu)
    rng = np.random.default_rng(7)
    batch = {"frontend_embeds": torch.from_numpy(rng.standard_normal(
                 (1, 16, cfg.d_model)).astype(np.float32)),
             "tokens": torch.from_numpy(rng.integers(0, cfg.vocab,
                                                     size=(1, 16))),
             "positions": mrope_positions(16, 4, 16)}
    runs, _, _ = parity_runs(model, cpu, gpu, batch, 36, 4, 32)
    worst, tokens = hold_logits("qwen2-vl", runs)
    say("parity", (
        f"qwen2-vl-72b full width, 1 layer, f32, 16 patch embeddings + 16 "
        f"tokens with M-RoPE positions: prefill and 4 greedy decode steps on "
        f"the card equal the CPU run: max |logit err| {worst!r}, tokens and "
        f"CPU top-1 margins {tokens}"))
    del cpu, gpu


def parity_jamba_ssm() -> None:
    """One of jamba's SSM layers at full width, f32 (a whole period is 53
    GB of f32 weights on each side; the CPU tests hold the hybrid model):
    ``ssm_prefill`` of 300 tokens (one launch of the f32 kernel with its
    state output) against the CPU, y, the conv tail and the final state
    within 1e-3 of each one's largest value, then 8 ``ssm_decode`` steps
    seeded from them."""
    cfg = get_config("jamba-v0.1-52b", dtype="float32")
    gpu = ssm.init_ssm(torch.Generator(device="cuda").manual_seed(8), cfg)
    cpu = host_copy(gpu)
    rng = np.random.default_rng(8)
    xs = [torch.from_numpy(rng.standard_normal((1, n, cfg.d_model)).astype(
        np.float32)) for n in [300] + [1] * 8]
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        zero_launches()
        with torch.no_grad():
            y, conv, state = ssm.ssm_prefill(params, cfg, xs[0].to(dev))
            got = [y, conv, state]
            for x in xs[1:]:
                y, conv, state = ssm.ssm_decode(params, cfg, x.to(dev), conv,
                                                state)
                got.append(y)
            got.append(state)
        out[dev] = [t.cpu() for t in got]
        if dev == "cuda":
            check(launches()["ssd"] == 1
                  and ssd_scan.ssd_scan_cuda.last_plan["variant"]
                  == "cuda_cores", "jamba SSM parity: one launch of the f32 "
                  "SSD kernel")
    names = ["y", "conv tail", "state"] + [f"decode {i}" for i in
                                           range(8)] + ["state after 8"]
    errs = {}
    for name, a, b in zip(names, out["cuda"], out["cpu"]):
        scale = float(b.abs().max())
        errs[name] = float((a - b).abs().max()) / scale
        check(errs[name] <= 1e-3, f"jamba SSM parity {name}: |err| / "
              f"largest {errs[name]}")
    say("parity", (
        f"jamba-v0.1-52b SSM layer at full width (H {cfg.ssm.n_ssm_heads(cfg.d_model)}, "
        f"P {cfg.ssm.head_dim}, N {cfg.ssm.d_state}), f32: ssm_prefill of 300 "
        f"tokens through the kernel with its state, then 8 ssm_decode "
        f"steps, equal the CPU: max |err| / largest per output {errs}"))


def device_time_by_name(prof) -> dict[str, list]:
    """``{kernel name: [device ms, launches]}`` from a profiler's raw CUDA
    events (key_averages takes minutes on long traces)."""
    by_name: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            acc = by_name.setdefault(e.name(), [0.0, 0])
            acc[0] += e.duration_ns() / 1e6
            acc[1] += 1
    return by_name


# --------------------------------------------------------------- 8. train
def phase_train() -> tuple[int, int]:
    """Returns the SSD forward and backward kernels' launches over the
    counted run."""
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    t0 = time.perf_counter()
    with PlainSSDOnCard() as plain:
        out = run_training(cfg, **TRAIN)
    wall = time.perf_counter() - t0
    ssd_launches = ssd_scan.ssd_scan_cuda.launches
    bwd_launches = ssd_scan.ssd_scan_bwd_cuda.launches
    others = (flash_attention.flash_attention_cuda.launches,
              vm_update.advance_sweep_cuda.launches)
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses, norms = out["losses"], out["grad_norms"]
    steps = TRAIN["steps"]
    check(out["steps_run"] == steps, f"ran {out['steps_run']} of {steps} steps")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"losses {losses} and grad norms {norms} finite")
    last5 = float(np.mean(losses[-5:]))
    check(last5 < losses[0], f"mean loss of the last 5 steps {last5} below "
          f"the first step's {losses[0]}")
    # under remat (the config's, as in the reference) the checkpointed
    # period runs its forward again in the backward
    per_step = (2 if cfg.remat else 1) * cfg.n_layers
    check(ssd_launches == per_step * steps == out["ssd_launches"],
          f"SSD launches {ssd_launches} (run_training counted "
          f"{out['ssd_launches']}) == {per_step} a step (remat {cfg.remat}, "
          f"{cfg.n_layers} layers) x {steps} steps")
    check(bwd_launches == cfg.n_layers * steps == out["ssd_bwd_launches"],
          f"SSD backward launches {bwd_launches} (run_training counted "
          f"{out['ssd_bwd_launches']}) == {cfg.n_layers} layers x {steps} "
          "steps")
    check(plain.calls == 0, f"the SSD's plain versions ran {plain.calls} "
          "times on the card during training")
    n_params = sum(x.numel() for x in tree.leaves(out["params"]))
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    first_step, after_first = out["step_seconds"][0], out["step_seconds"][1:]
    mean_step = sum(after_first) / len(after_first)
    TRAIN_RUN.update(losses=list(losses), step_s=mean_step, peak=peak)

    # two more steps under the profiler: where the device time goes
    model = build_model(cfg)
    step_fn = make_train_step(model, OptConfig(lr=TRAIN["lr"]))
    params, opt_state = out["params"], adamw_init(out["params"])
    loader = ShardedLoader(cfg.vocab, TRAIN["global_batch"], TRAIN["seq_len"],
                           seed=1)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
               for _ in range(2)]
    loader.close()
    del out
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for batch in batches:
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            float(metrics["loss"])
        traced_wall = time.perf_counter() - t1
    by_name = device_time_by_name(prof)
    busy_ms = sum(ms for ms, _ in by_name.values())
    ssd_phases = ssd_phase_ms(by_name, 1)
    ssd_ms = sum(ssd_phases.values())
    bwd_ms = sum(v for k, v in ssd_phases.items() if "bwd" in k)
    share = (f"{ssd_ms / busy_ms!r} ({ssd_ms!r} ms of {busy_ms!r} ms device "
             f"time, of which the backward kernel {bwd_ms!r} ms, "
             f"{bwd_ms / busy_ms!r}; by kernel {ssd_phases}; idle share "
             f"{1 - busy_ms / 1e3 / traced_wall!r} of the traced wall "
             f"{traced_wall!r} s)" if busy_ms > 0 else "not measured")
    say("train", f"2 traced steps: {sum(n for _, n in by_name.values())} "
        f"device activities, {busy_ms!r} ms device time; the most:")
    for name, (ms, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        print(f"    {ms:10.3f} ms  {n:6d} launches  {name[:100]}")
    say("train", (
        f"{TRAIN_ARCH} full width and depth ({cfg.n_layers} layers, "
        f"{n_params} parameters, f32 weights and AdamW, bf16 compute): "
        f"{steps} steps of {TRAIN['global_batch']} x {TRAIN['seq_len']} "
        f"tokens, lr {TRAIN['lr']}: wall {wall!r} s, first step "
        f"{first_step!r} s, then {mean_step!r} s a step (min "
        f"{min(after_first)!r}, max {max(after_first)!r}) = "
        f"{tokens / mean_step!r} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}; grad norms "
        f"{[round(x, 3) for x in norms]}; SSD kernel {ssd_launches} "
        f"launches, backward {bwd_launches} (flash {others[0]}, advance sweep "
        f"{others[1]}); the SSD's plain versions on the card {plain.calls} "
        f"times; SSD share of device time {share}; peak memory {peak!r} "
        "GiB"))
    del params, opt_state, batches, prof
    torch.cuda.empty_cache()
    return ssd_launches, bwd_launches


# ------------------------------------------------------- 8b. dense train
def attn_layers(cfg) -> int:
    """Attention calls of one forward: every attention sub-layer of an LM;
    an encoder-decoder's encoder layers and both attentions of each decoder
    layer."""
    if cfg.family == "encdec":
        return cfg.encoder.n_layers + 2 * cfg.n_layers
    return mixers(cfg, "attn")


def train_counts(cfg, steps: int, fwd: int, bwd: int, label: str) -> None:
    """Under remat the forward runs twice per attention layer per step (the
    checkpointed period again in the backward), the backward once."""
    n = attn_layers(cfg)
    check(fwd == 2 * n * steps and bwd == n * steps,
          f"{label}: flash forward launches {fwd} == 2 x {n} attention layers "
          f"x {steps} steps, backward {bwd} == {n} x {steps}")


def profile_train_steps(label: str, model, state: list, batches,
                        opt_cfg) -> None:
    """Steps under the profiler, the gradient and the AdamW update in
    windows of their own (a synchronisation between them): device time by
    kernel class in the gradient's window, AdamW's as one class, and the
    idle share of the two windows' wall.  ``state`` is ``[params,
    opt_state]``, emptied here so that each step's old state can be freed
    (two generations of f32 weights and moments would not fit)."""
    params, opt_state = state
    state.clear()
    grad_by, opt_by, wall = {}, {}, 0.0
    for batch in batches:
        for part, into in (("grad", grad_by), ("adamw", opt_by)):
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if part == "grad":
                    loss, grads = value_and_grad(model, params, batch)
                    float(loss)
                else:
                    params, opt_state, metrics = adamw_update(
                        grads, opt_state, params, opt_cfg)
                    float(metrics["grad_norm"])
                    del grads
                wall += time.perf_counter() - t0
            for name, (ms, n) in device_time_by_name(prof).items():
                acc = into.setdefault(name, [0.0, 0])
                acc[0] += ms
                acc[1] += n
    busy = sum(ms for ms, _ in grad_by.values())
    adamw = sum(ms for ms, _ in opt_by.values())
    classes = {c: [round(ms, 3), n] for c, (ms, n) in sorted(
        kernel_classes(grad_by).items(), key=lambda kv: -kv[1][0])}
    classes["AdamW (its window)"] = [round(adamw, 3),
                                     sum(n for _, n in opt_by.values())]
    idle = (f"{1 - (busy + adamw) / 1e3 / wall!r}" if busy > 0
            else "not measured")
    say("dense train", (
        f"{label}: {len(batches)} profiled steps, {busy + adamw!r} ms device "
        f"time in a wall of {wall!r} s, idle share {idle}; device ms and "
        f"launches by class {classes}; the most:"))
    for name, (ms, n) in sorted(grad_by.items(), key=lambda kv: -kv[1][0])[:8]:
        print(f"    {ms:10.3f} ms  {n:6d} launches  {name[:100]}")


def flash_since(start: dict) -> tuple[int, int]:
    """The flash forward and backward launches since ``launches()`` gave
    ``start``."""
    now = launches()
    return now["flash"] - start["flash"], now["flash_bwd"] - start["flash_bwd"]


def ssd_since(start: dict) -> tuple[int, int]:
    """The SSD forward and backward launches since ``launches()`` gave
    ``start``."""
    now = launches()
    return now["ssd"] - start["ssd"], now["ssd_bwd"] - start["ssd_bwd"]


def dense_run(arch: str, kw: dict) -> tuple[int, int]:
    """``run_training`` of ``arch`` at full width and depth; the
    internlm2 run is also profiled over 2 more steps.  Returns the flash
    forward and backward launches, the profiled steps' included."""
    cfg = get_config(arch)
    start = launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run_training(cfg, **kw)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    steps, losses, norms = kw["steps"], out["losses"], out["grad_norms"]
    check(out["steps_run"] == steps, f"{arch}: ran {out['steps_run']} of "
          f"{steps} steps")
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"{arch}: losses {losses} and grad norms {norms} finite")
    fwd, bwd = out["flash_launches"], out["flash_bwd_launches"]
    train_counts(cfg, steps, fwd, bwd, arch)
    last5 = float(np.mean(losses[-5:]))
    if arch == "internlm2-1.8b":
        check(last5 < losses[0], f"{arch}: mean loss of the last 5 steps "
              f"{last5} below the first step's {losses[0]}")
    after_first = out["step_seconds"][1:]
    DENSE_RUNS[arch] = {"losses": list(losses), "peak": peak,
                        "step_s": sum(after_first) / len(after_first)}
    n_params = sum(x.numel() for x in tree.leaves(out["params"]))
    if arch != "internlm2-1.8b":
        del out["params"]
    say("dense train", (
        f"{arch} full width and depth ({cfg.n_layers} layers, {n_params} "
        f"parameters, f32 weights and AdamW, bf16 compute, remat "
        f"{cfg.remat}): {steps} steps of {kw['global_batch']} x "
        f"{kw['seq_len']} tokens, lr {kw['lr']}: wall {wall!r} s, first "
        f"step {out['step_seconds'][0]!r} s, then "
        f"{sum(after_first) / len(after_first)!r} s a step (min "
        f"{min(after_first)!r}, max {max(after_first)!r}) = "
        f"{out['tokens_per_sec']!r} tokens/s; losses "
        f"{[round(x, 4) for x in losses]}, last 5 mean {last5!r}; grad "
        f"norms {[round(x, 3) for x in norms]}; flash forward {fwd} and "
        f"backward {bwd} launches; peak memory {peak!r} GiB"))
    if arch == "internlm2-1.8b":
        model = build_model(cfg)
        opt_cfg = OptConfig(lr=kw["lr"])
        params = out.pop("params")
        del out
        state = [params, adamw_init(params)]
        del params
        loader = ShardedLoader(cfg.vocab, kw["global_batch"], kw["seq_len"],
                               seed=1)
        batches = [{k: torch.from_numpy(v).cuda()
                    for k, v in next(loader).items()} for _ in range(2)]
        loader.close()
        before = launches()
        profile_train_steps(f"{arch} ({kw['global_batch']} x "
                            f"{kw['seq_len']} tokens)", model, state,
                            batches, opt_cfg)
        train_counts(cfg, len(batches), *flash_since(before),
                     f"{arch} profiled steps")
        del batches
    torch.cuda.empty_cache()
    return flash_since(start)


class GCPauses:
    """Seconds the cyclic garbage collector held the host while entered."""

    def __enter__(self):
        self.seconds, self._t0 = 0.0, 0.0
        gc.callbacks.append(self._callback)
        return self

    def _callback(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)


def whisper_train() -> tuple[int, int]:
    """whisper-large-v3 at full width and depth through ``make_train_step``
    on a batch of frame embeddings, tokens and next-token labels: the
    non-causal encoder over 1,500 frames and cross-attention with Sq != Sk
    under the backward.  Returns the flash forward and backward launches."""
    w = WHISPER_TRAIN
    cfg = get_config("whisper-large-v3")
    model = build_model(cfg)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    opt_state = adamw_init(params)
    gen = torch.Generator(device="cuda").manual_seed(5)
    full = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, size=(w["batch"], w["tokens"] + 1))).cuda()
    batch = {"frames": torch.randn(w["batch"], cfg.encoder.n_ctx, cfg.d_model,
                                   device="cuda", generator=gen),
             "tokens": full[:, :-1], "labels": full[:, 1:].contiguous()}
    step_fn = make_train_step(model, OptConfig(lr=w["lr"], warmup_steps=1,
                                               total_steps=w["steps"]))
    start = launches()
    losses, norms, seconds, gc_seconds = [], [], [], []
    for _ in range(w["steps"]):
        with GCPauses() as pauses:
            t0 = time.perf_counter()
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            seconds.append(time.perf_counter() - t0)
        gc_seconds.append(pauses.seconds)
    fwd, bwd = flash_since(start)
    check(all(np.isfinite(losses)) and all(np.isfinite(norms)),
          f"whisper: losses {losses} and grad norms {norms} finite")
    train_counts(cfg, w["steps"], fwd, bwd, "whisper")
    step_s = sum(seconds[1:]) / len(seconds[1:])
    say("dense train", (
        f"whisper-large-v3 full width and depth ({cfg.encoder.n_layers} + "
        f"{cfg.n_layers} layers, f32 weights and AdamW, bf16 compute, remat "
        f"{cfg.remat}) through make_train_step: {w['steps']} steps of "
        f"{w['batch']} x {cfg.encoder.n_ctx} frames and {w['tokens']} "
        f"tokens: step seconds {seconds} (of which the garbage collector "
        f"{gc_seconds}), {w['batch'] * cfg.encoder.n_ctx / step_s!r}"
        f" frames/s after the first; losses {losses}, grad norms {norms}; "
        f"flash forward {fwd} and backward {bwd} launches; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB"))
    del params, opt_state, batch
    torch.cuda.empty_cache()
    return fwd, bwd


def phase_dense_train() -> tuple[int, int]:
    """8b: the attention models train on the card.  Returns the flash
    forward and backward launches of the three runs."""
    fwd = bwd = 0
    for arch, kw in DENSE_TRAIN:
        f, b = dense_run(arch, kw)
        fwd, bwd = fwd + f, bwd + b
    f, b = whisper_train()
    return fwd + f, bwd + b


# ------------------------------------------------------- 9. train parity
def phase_train_parity() -> None:
    """mamba2-130m at full width, 2 layers, f32: one train step against the
    CPU, and ``lm_logits`` within atol/rtol 1e-3; then the attention
    models' train steps."""
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, dtype="float32"),
                              n_layers=2)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(2))
    full = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 513))
    batch = {"tokens": torch.from_numpy(full[:, :-1]),
             "labels": torch.from_numpy(full[:, 1:].copy())}
    train_step_parity(f"{TRAIN_ARCH} full width, 2 layers, f32, batch 2 x "
                      "512", model, cpu, batch)
    with torch.no_grad():
        z0 = lm_logits(cpu, cfg, batch["tokens"])
        z1 = lm_logits(tree.map_tree(lambda t: t.to("cuda"), cpu), cfg,
                       batch["tokens"].cuda()).cpu()
    err = float((z1 - z0).abs().max())
    check(torch.allclose(z1, z0, atol=1e-3, rtol=1e-3),
          f"train parity lm_logits within 1e-3 ({err})")
    say("train parity", f"{TRAIN_ARCH}: lm_logits on the card equal the "
        f"CPU's: max |logit err| {err!r}")
    attention_train_parity()


def train_step_parity(label: str, model, cpu_params, batch: dict) -> None:
    """One train step (``value_and_grad``, then ``adamw_update``: the body
    of ``make_train_step``) on the CPU and on the card from the same f32
    parameters and batch: the loss within rtol 1e-4, the gradient norm
    likewise, each gradient leaf within 1e-3 of its largest value.  On the
    card attention runs the f32 flash forward and backward kernels, an SSM
    layer the f32 SSD forward and backward kernels (all counted).
    cuBLAS and the kernels add in other orders than the CPU: ~1e-6
    relative per layer.  Parameters after the step are not compared: at
    step 1 AdamW moves a weight by about lr times the sign of its gradient,
    so a tiny gradient of opposite sign differs by 2 lr."""
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=5, total_steps=20)
    gpu_params = tree.map_tree(lambda t: t.to("cuda"), cpu_params)
    runs, counted, ssd_counted = {}, {}, {}
    for dev, params in (("cpu", cpu_params), ("cuda", gpu_params)):
        b = {k: v.to(dev) for k, v in batch.items()}
        start = launches()
        loss, grads = value_and_grad(model, params, b)
        _, _, metrics = adamw_update(grads, adamw_init(params), params,
                                     opt_cfg)
        counted[dev] = flash_since(start)
        ssd_counted[dev] = ssd_since(start)
        runs[dev] = (float(loss), float(metrics["grad_norm"]),
                     {tree.key(p): v.cpu()
                      for p, v in tree.leaves_with_path(grads)})
        del grads, metrics
    del gpu_params
    n = attn_layers(model.cfg)
    check(counted["cpu"] == (0, 0) and counted["cuda"] == (2 * n, n),
          f"{label} train parity: the CPU launched no kernel, the card "
          f"{counted['cuda']} flash forward and backward == (2 x {n}, {n})")
    cfg = model.cfg
    m = 0 if cfg.family == "encdec" else mixers(cfg, "ssm")
    want_ssd = ((2 if cfg.remat else 1) * m, m)
    check(ssd_counted["cpu"] == (0, 0) and ssd_counted["cuda"] == want_ssd,
          f"{label} train parity: the CPU launched no SSD kernel, the card "
          f"{ssd_counted['cuda']} SSD forward and backward == {want_ssd} "
          f"({m} SSM layers, remat {cfg.remat})")
    (l0, n0, g0), (l1, n1, g1) = runs["cpu"], runs["cuda"]
    check(abs(l1 - l0) <= 1e-4 * abs(l0), f"{label} train parity loss {l1} "
          f"vs {l0}")
    check(abs(n1 - n0) <= 1e-4 * abs(n0), f"{label} train parity grad norm "
          f"{n1} vs {n0}")
    worst = 0.0
    for k in g0:
        scale = float(g0[k].abs().max())
        err = float((g1[k] - g0[k]).abs().max())
        check(err <= 1e-3 * scale, f"{label} train parity gradient {k}: "
              f"{err} vs largest {scale}")
        worst = max(worst, err / scale if scale else 0.0)
    say("train parity", (
        f"{label}: one train step on the card (flash forward and backward "
        f"kernels, f32, {counted['cuda']} launches; SSD forward and backward "
        f"{ssd_counted['cuda']}) equals the CPU: loss "
        f"{l1!r} vs {l0!r}, grad norm {n1!r} vs {n0!r}; {len(g0)} gradient "
        f"leaves, worst |err| / largest |grad| {worst!r}"))


def attention_train_parity() -> None:
    """internlm2-1.8b at full width, 2 layers, batch 2 x 512; gemma2 narrow
    (2 layers, 4/2 heads of D 128, d_model 512, a 256-token window under a
    512-token sequence, both softcaps, its vocabulary); whisper narrow
    (2 + 2 layers, 4 heads of D 64, 300 frames, 64 tokens)."""
    rng = np.random.default_rng(7)

    def lm_batch(vocab: int, b: int, s: int) -> dict:
        full = rng.integers(0, vocab, size=(b, s + 1))
        return {"tokens": torch.from_numpy(full[:, :-1].copy()),
                "labels": torch.from_numpy(full[:, 1:].copy())}

    cfg = dataclasses.replace(get_config(SERVE_ARCH, dtype="float32"),
                              n_layers=2)
    model = build_model(cfg)
    train_step_parity(f"{SERVE_ARCH} full width, 2 layers, batch 2 x 512",
                      model, model.init(torch.Generator().manual_seed(8)),
                      lm_batch(cfg.vocab, 2, 512))
    cfg = dataclasses.replace(
        get_config("gemma2-27b", dtype="float32"), n_layers=2, d_model=512,
        n_heads=4, n_kv_heads=2, d_head=128, d_ff=2048, sliding_window=256)
    model = build_model(cfg)
    train_step_parity(
        "gemma2-27b narrow (2 layers, d_model 512, 4/2 heads of D 128, "
        "window 256 under 512 tokens, softcaps 50 / 30)", model,
        model.init(torch.Generator().manual_seed(9)),
        lm_batch(cfg.vocab, 2, 512))
    full = get_config("whisper-large-v3", dtype="float32")
    cfg = dataclasses.replace(
        full, n_layers=2, d_model=256, n_heads=4, n_kv_heads=4, d_ff=1024,
        encoder=dataclasses.replace(full.encoder, n_layers=2))
    model = build_model(cfg)
    batch = lm_batch(cfg.vocab, 2, 64)
    batch["frames"] = torch.from_numpy(
        rng.standard_normal((2, 300, cfg.d_model)).astype(np.float32))
    train_step_parity(
        "whisper-large-v3 narrow (2 + 2 layers, d_model 256, 4 heads of D "
        "64, 300 frames, 64 tokens)", model,
        model.init(torch.Generator().manual_seed(10)), batch)
    torch.cuda.empty_cache()



# ------------------------------------------------- 10. elastic and mesh
def elastic_run() -> tuple[int, int, int]:
    """(a) ``ElasticRunner`` on mamba2-130m at full width and depth.
    Returns the SSD forward, SSD backward and advance-sweep launches of the
    run."""
    e = ELASTIC
    cfg = get_config(TRAIN_ARCH)
    start = launches()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as where:
        runner = ElasticRunner(
            cfg, where, steps=e["steps"], global_batch=e["global_batch"],
            seq_len=e["seq_len"], ckpt_every=e["ckpt_every"],
            n_workers=e["n_workers"])
        t0 = time.perf_counter()
        out = runner.run(fail_at_steps=list(e["fail_at"]))
        wall = time.perf_counter() - t0
        disk = sum(f.stat().st_size for f in Path(where).rglob("*")
                   if f.is_file())
    now = launches()
    ssd, sweeps = now["ssd"] - start["ssd"], now["sweep"] - start["sweep"]
    ssd_bwd = now["ssd_bwd"] - start["ssd_bwd"]
    events = out["events"]
    check([ev["kind"] for ev in events] == ["failure", "failure", "finished"]
          and out["restarts"] == 2, f"elastic events {events}")
    check([ev["resume_step"] for ev in events[:2]] == [6, 12],
          f"elastic resume steps {[ev['resume_step'] for ev in events[:2]]}")
    final = out["result"]["final_loss"]
    check(bool(np.isfinite(final)), f"elastic final loss {final} finite")
    # each run trains from its resume step to its failure (or the end)
    ran = sum(stop - begin for begin, stop in zip(
        [0, 6, 12], e["fail_at"] + [e["steps"]]))
    per_step = (2 if cfg.remat else 1) * cfg.n_layers
    check(ssd == per_step * ran, f"elastic: SSD launches {ssd} == "
          f"{per_step} a step x {ran} steps run")
    check(ssd_bwd == cfg.n_layers * ran, f"elastic: SSD backward launches "
          f"{ssd_bwd} == {cfg.n_layers} a step x {ran} steps run")
    # each plan simulates two one-DC scenarios: one launch per batch step
    planned = 0
    for ev in events[:2]:
        left = e["steps"] - ev["resume_step"]
        for n, delay in ((ev["survivors"], 0.0), (e["n_workers"], 600.0)):
            planned += int(simulate(restart_scenario(
                left * 1000.0, e["n_workers"], n, delay, device="cpu"),
                device="cpu").n_events)
    check(sweeps == planned > 0, f"elastic: advance-sweep launches {sweeps} "
          f"== the plans' batch steps {planned}")
    say("elastic", (
        f"{TRAIN_ARCH} full width and depth ({cfg.n_layers} layers, bf16 "
        f"compute, remat {cfg.remat}), {e['steps']} steps of "
        f"{e['global_batch']} x {e['seq_len']} tokens, checkpoints every "
        f"{e['ckpt_every']}, failures at {e['fail_at']}: events "
        f"{[(ev['kind'], ev.get('resume_step'), ev.get('survivors'), ev.get('plan', {}).get('choice')) for ev in events]}; "
        f"{ran} steps run, final loss {final!r}; wall {wall!r} s; "
        f"checkpoints {disk / 2**30!r} GiB on disk; SSD {ssd} launches "
        f"(backward {ssd_bwd}), advance sweep {sweeps} (the two plans); peak "
        f"memory "
        f"{torch.cuda.max_memory_allocated() / 2**30!r} GiB"))
    del out, runner
    torch.cuda.empty_cache()
    return ssd, ssd_bwd, sweeps


def save_named_run() -> tuple[int, int]:
    """(b) internlm2-1.8b at full width and depth under
    ``remat_policy="save_named"``, against phase 8b's ``"none"`` run, then
    one gradient's peak memory under each policy.  Returns the flash
    forward and backward launches."""
    arch, kw = DENSE_TRAIN[0]
    cfg = dataclasses.replace(get_config(arch), remat_policy="save_named")
    kw = dict(kw, steps=SAVE_NAMED_STEPS)
    none = DENSE_RUNS[arch]
    start, copies = launches(), layers.remat_ckpt.copies
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out = run_training(cfg, **kw)
    peak = torch.cuda.max_memory_allocated() / 2**30
    fwd, bwd = flash_since(start)
    copies = layers.remat_ckpt.copies - copies
    steps = kw["steps"]
    train_counts(cfg, steps, fwd, bwd, f"{arch} save_named")
    tags = 2 * cfg.n_layers * steps      # the mixer's and the MLP's outputs
    check(copies == tags, f"save_named: {copies} tag copies == {tags} (one "
          "per tag per forward; the replay takes the saved copy)")
    losses, want = out["losses"], none["losses"][:steps]
    bitwise = losses == want
    check(all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(losses, want)),
          f"save_named losses {losses} equal 'none''s {want}")
    step_s = sum(out["step_seconds"][1:]) / (steps - 1)
    grad_peak = save_named_grad_peaks(cfg, out.pop("params"), kw)
    total = flash_since(start)
    n = attn_layers(cfg)
    check(total == (fwd + 2 * 2 * n, bwd + 2 * n), f"save_named: flash "
          f"launches {total} == the run's ({fwd}, {bwd}) and two gradients'")
    say("save_named", (
        f"{arch} full width and depth, remat_policy save_named: {steps} steps "
        f"of {kw['global_batch']} x {kw['seq_len']} tokens: losses {losses} "
        f"vs phase 8b's 'none' {want} (bitwise {bitwise}); flash forward "
        f"{fwd / steps} and backward {bwd / steps} launches a step; "
        f"{copies / steps} tag copies a step; {step_s!r} s a step after the "
        f"first (none: {none['step_s']!r}, ratio "
        f"{step_s / none['step_s']!r}); peak memory {peak!r} GiB (none: "
        f"{none['peak']!r}, +{peak - none['peak']!r}: the peak is AdamW's); "
        f"one gradient's peak above the held weights {grad_peak}"))
    del out
    torch.cuda.empty_cache()
    return total


def save_named_grad_peaks(cfg, params, kw) -> dict[str, float]:
    """GiB one ``value_and_grad`` adds to the held weights at its peak, under
    each policy, on one batch of ``kw``'s shape: the training run's peak
    is AdamW's, which hides the saved tags.  Frees ``params``."""
    loader = ShardedLoader(cfg.vocab, kw["global_batch"], kw["seq_len"],
                           seed=1)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(loader).items()}
    loader.close()
    peaks = {}
    for policy in ("none", "save_named"):
        model = build_model(dataclasses.replace(cfg, remat_policy=policy))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss, grads = value_and_grad(model, params, batch)
        float(loss)
        peaks[policy] = (torch.cuda.max_memory_allocated() - base) / 2**30
        del loss, grads
    peaks["save_named - none"] = peaks["save_named"] - peaks["none"]
    del params, batch
    torch.cuda.empty_cache()
    return peaks


def mesh_moe(mesh) -> None:
    """granite-moe's MoE layer at full width, f32: the expert-parallel path
    on the mesh against the local path, at both schedules."""
    cfg = get_config("granite-moe-1b-a400m", dtype="float32")
    params = moe.init_moe(torch.Generator(device="cuda").manual_seed(3), cfg)
    for schedule, b, s in MESH_MOE:
        x = torch.randn(b, s, cfg.d_model, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(b))
        y0, aux0 = moe._moe_local(params, cfg, x)
        with activation_shardings(mesh):
            y1, aux1 = moe.moe_apply(params, cfg, x)
        ran = moe._moe_shard_map.schedule
        err, aerr = float((y1 - y0).abs().max()), float((aux1 - aux0).abs())
        check(ran == schedule and err <= 2e-4 and aerr <= 1e-4,
              f"mesh MoE {b} x {s}: schedule {ran} (want {schedule}), "
              f"max |err| {err} <= 2e-4, aux {aerr} <= 1e-4")
        say("mesh", (
            f"granite-moe-1b-a400m MoE layer (E {cfg.moe.n_experts}, top "
            f"{cfg.moe.top_k}, D {cfg.d_model}, F {cfg.moe.d_ff}, f32), "
            f"{b} x {s} tokens: the expert-parallel path ({ran}) on the "
            f"(1, 1) mesh against the local path: max |err| {err!r}, aux "
            f"{aerr!r} (bitwise {torch.equal(y0, y1) and torch.equal(aux0, aux1)})"))
        del x, y0, y1


def mesh_campaign(mesh, phase4: dict) -> int:
    """Phase 4's campaign through ``run_campaign(mesh=)``.  Returns its
    batch steps (= advance-sweep launches)."""
    rows = [scenarios.fig9_10_scenario(vp) for vp in (SPACE_SHARED,
                                                      TIME_SHARED)]
    batch = stack_scenarios(rows * (CAMPAIGN_ROWS // 2))
    t0 = time.perf_counter()
    res = run_campaign(batch, mesh=mesh)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = result_to_numpy(res)
    same = all(got[k].shape == phase4[k].shape and (got[k] == phase4[k]).all()
               for k in phase4)
    check(same, "the mesh campaign is bitwise phase 4's")
    steps = int(res.n_events.max())
    say("mesh", f"{CAMPAIGN_ROWS} x fig9_10 through run_campaign(mesh=) on "
        f"the (1, 1) mesh: bitwise phase 4's result, {steps} batch steps, "
        f"{secs!r} s")
    return steps


def mesh_params(mesh) -> None:
    """internlm2-1.8b's parameters through ``named`` and
    ``distribute_tensor`` (``dist.distribute``): ``full_tensor()`` bitwise
    each leaf."""
    model = build_model(get_config(SERVE_ARCH))
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    specs = param_pspec_tree(params, mesh)
    placed = named(mesh, specs)
    shards = distribute(mesh, params, specs)
    n = 0
    for (path, x), d in zip(tree.leaves_with_path(params),
                            tree.leaves(shards)):
        pl = placed
        for k in path:
            pl = pl[k]
        check(tuple(d.placements) == pl and torch.equal(d.full_tensor(), x),
              f"{tree.key(path)} through distribute_tensor: placements "
              f"{d.placements} == named's {pl}, full_tensor() bitwise")
        n += 1
    say("mesh", f"{SERVE_ARCH} at full width and depth: {n} parameter leaves "
        f"through named() + distribute_tensor on the (1, 1) mesh, "
        f"full_tensor() bitwise each")
    del params, shards
    torch.cuda.empty_cache()


def phase_mesh(phase4: dict) -> int:
    """(c) the mesh layer on one card: NCCL at world size 1, a ``(1, 1)``
    ``("data", "model")`` mesh.  Returns the advance-sweep launches."""
    with tempfile.TemporaryDirectory() as where:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(where) / "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_host_mesh((1, 1), ("data", "model"))
            probe = torch.ones(4, device="cuda")
            dist.all_reduce(probe)
            torch.cuda.synchronize()
            check(bool((probe == 1).all()), "an NCCL all-reduce at world "
                  "size 1")
            mesh_moe(mesh)
            steps = mesh_campaign(mesh, phase4)
            mesh_params(mesh)
        finally:
            dist.destroy_process_group()
    return steps


def phase_elastic_mesh(phase4: dict) -> dict[str, int]:
    """10: the elastic trainer, the save_named policy and the mesh layer.
    Returns each kernel's launches in the phase."""
    zero_launches()
    t0 = time.perf_counter()
    ssd, ssd_bwd, sweeps = elastic_run()
    took = {"elastic": time.perf_counter() - t0}
    fwd, bwd = save_named_run()
    took["save_named"] = time.perf_counter() - t0 - sum(took.values())
    sweeps += phase_mesh(phase4)
    took["mesh"] = time.perf_counter() - t0 - sum(took.values())
    counted = launches()
    check(counted == {"flash": fwd, "ssd": ssd, "sweep": sweeps,
                      "flash_bwd": bwd, "ssd_bwd": ssd_bwd},
          f"phase 10 launches {counted} == its runs' ({fwd}, {ssd}, "
          f"{sweeps}, {bwd}, {ssd_bwd})")
    say("timing", "elastic and mesh: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in took.items()))
    return counted


# ------------------------------------------- 11. sharded step and dry-run
def sharded_run(mesh, arch: str, kw: dict, steps: int, want: dict,
                kernel: str) -> dict:
    """(a) ``steps`` of ``run_training``'s steps for ``arch`` (its
    parameters, schedule and tokens) through the sharded step: ``DTensor``
    parameters from ``distribute`` of its init by ``param_pspec_tree``,
    AdamW moments from ``adamw_init`` of them, each batch placed by
    ``input_pspec_tree``, ``param_shardings`` the parameters' placements,
    inside ``activation_shardings``.  ``want`` is the unsharded run's
    record; ``kernel`` the kernel whose ``local_map`` blocks are counted.
    Returns the run's record."""
    cfg = get_config(arch)
    model = build_model(cfg)
    opt_cfg = OptConfig(lr=kw["lr"], warmup_steps=max(kw["steps"] // 20, 5),
                        total_steps=kw["steps"])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = model.init(torch.Generator("cuda").manual_seed(kw["seed"]))
    specs = param_pspec_tree(params, mesh)
    placed = distribute(mesh, params, specs)
    del params
    state = adamw_init(placed)
    step_fn = make_train_step(model, opt_cfg,
                              param_shardings=named(mesh, specs))
    loader = ShardedLoader(cfg.vocab, kw["global_batch"], kw["seq_len"],
                           seed=kw["seed"])
    before, blocks = launches(), dict(ops.local_map_blocks)
    losses, seconds = [], []
    try:
        for _, batch in zip(range(steps), loader):
            tb = {k: torch.from_numpy(v).cuda() for k, v in batch.items()}
            tb = distribute(mesh, tb, input_pspec_tree({"batch": tb},
                                                       mesh)["batch"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with activation_shardings(mesh):
                placed, state, metrics = step_fn(placed, state, tb)
            losses.append(float(metrics["loss"].full_tensor()))
            seconds.append(time.perf_counter() - t0)
    finally:
        loader.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    now = launches()
    counts = {k: now[k] - before[k] for k in now}
    through = ops.local_map_blocks[kernel] - blocks[kernel]
    placed_ok = all(tuple(a.placements) == tuple(b.placements)
                    for a, b in zip(tree.leaves(placed),
                                    tree.leaves(state["mu"])))
    del placed, state, tb
    torch.cuda.empty_cache()
    ref = want["losses"][:steps]
    gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
    check(gap <= SHARDED_LOSS_TOL,
          f"sharded {arch}: losses {losses} equal the unsharded run's {ref} "
          f"within {SHARDED_LOSS_TOL} relative (worst {gap!r})")
    check(placed_ok, f"sharded {arch}: updated parameters keep the moments' "
          "placements")
    # the first step fills DTensor's sharding caches; the last is timed
    return {"losses": losses, "want": ref, "gap": gap, "step_s": seconds[-1],
            "seconds": seconds, "peak": peak, "launches": counts,
            "blocks": through}


def sharded_steps() -> dict[str, int]:
    """(a) NCCL at world size 1, a (1, 1) mesh: internlm2 and mamba2
    through the sharded step.  Returns the kernels' launches."""
    arch, kw = DENSE_TRAIN[0]
    cfg = get_config(arch)
    n = attn_layers(cfg)
    steps, m_steps = SHARDED_STEPS[arch], SHARDED_STEPS[TRAIN_ARCH]
    with tempfile.TemporaryDirectory() as where:
        dist.init_process_group("nccl", store=dist.FileStore(
            str(Path(where) / "store"), 1), rank=0, world_size=1)
        try:
            mesh = make_host_mesh((1, 1), ("data", "model"))
            dense = sharded_run(mesh, arch, kw, steps, DENSE_RUNS[arch],
                                "flash_attention")
            ssm_run = sharded_run(mesh, TRAIN_ARCH, TRAIN, m_steps,
                                  TRAIN_RUN, "ssd_scan")
        finally:
            dist.destroy_process_group()
    c = dense["launches"]
    check(c["flash"] == 2 * n * steps and c["flash_bwd"] == n * steps
          and dense["blocks"] == c["flash"],
          f"sharded {arch}: flash forward {c['flash']} == 2 x {n} x {steps}, "
          f"backward {c['flash_bwd']} == {n} x {steps}, each forward through "
          f"local_map ({dense['blocks']} blocks)")
    m = ssm_run["launches"]
    n_ssm = get_config(TRAIN_ARCH).n_layers
    check(m["ssd"] == 2 * n_ssm * m_steps and ssm_run["blocks"] == m["ssd"],
          f"sharded {TRAIN_ARCH}: SSD launches {m['ssd']} == 2 x {n_ssm} x "
          f"{m_steps}, each through local_map ({ssm_run['blocks']} blocks)")
    check(m["ssd_bwd"] == n_ssm * m_steps, f"sharded {TRAIN_ARCH}: SSD "
          f"backward launches {m['ssd_bwd']} == {n_ssm} x {m_steps}")
    want = DENSE_RUNS[arch]
    say("sharded step", (
        f"{arch} full width and depth through the sharded step (DTensor "
        f"parameters and moments on the (1, 1) mesh, NCCL world size 1, "
        f"flash under local_map), {steps} of phase 8b's steps of "
        f"{kw['global_batch']} x {kw['seq_len']} tokens: losses "
        f"{dense['losses']} vs the plain step's {dense['want']}, worst "
        f"relative gap {dense['gap']!r} (bitwise "
        f"{dense['losses'] == dense['want']}); flash forward "
        f"{c['flash'] / steps} and backward {c['flash_bwd'] / steps} "
        f"launches a step; step {steps} took {dense['step_s']!r} s (the "
        f"plain step: {want['step_s']!r} s, ratio "
        f"{dense['step_s'] / want['step_s']!r}; every step "
        f"{dense['seconds']}); peak memory {dense['peak']!r} GiB (the plain "
        f"step: {want['peak']!r})"))
    say("sharded step", (
        f"{TRAIN_ARCH} full width and depth through the sharded step, "
        f"{m_steps} of phase 8's steps: losses {ssm_run['losses']} vs the "
        f"plain step's {ssm_run['want']}, worst relative gap "
        f"{ssm_run['gap']!r}; SSD {m['ssd'] / m_steps} launches a step "
        f"(backward {m['ssd_bwd'] / m_steps}); step "
        f"{m_steps} took {ssm_run['step_s']!r} s (the plain step: "
        f"{TRAIN_RUN['step_s']!r} s; every step {ssm_run['seconds']}); peak "
        f"memory {ssm_run['peak']!r} GiB (the plain step: "
        f"{TRAIN_RUN['peak']!r})"))
    SHARDED_RUNS[arch] = dense
    return {k: c[k] + m[k] for k in c}


def dryrun_card_cell() -> None:
    """(b) the dry-run's ``lower_cell`` of (a)'s internlm2 cell on a (1, 1)
    mesh over a fake process group, beside (a)'s measurements."""
    arch, kw = DENSE_TRAIN[0]
    shape = ShapeSpec("phase 8b", kw["seq_len"], kw["global_batch"], "train")
    with dryrun.fake_world(1):
        mesh = make_host_mesh((1, 1), ("data", "model"))
        t0 = time.perf_counter()
        trace, meta = dryrun.lower_cell(arch, shape, mesh, microbatches=1)
        took = time.perf_counter() - t0
        est = memest.estimate(meta["model"], meta["cfg"], shape, mesh,
                              microbatches=1)
    six_nd = roofline.model_flops_for(meta["cfg"], shape)
    rl = roofline.analyze_walk(trace, est, 1, six_nd)
    run = SHARDED_RUNS[arch]
    gib = 2**30
    n = attn_layers(meta["cfg"])
    check(trace.kernel_calls == {"flash_attention_fwd": 2 * n,
                                 "flash_attention_bwd": n},
          f"the traced step calls the flash ops {trace.kernel_calls}: 2 x {n} "
          f"forward, {n} backward")
    check(trace.dot_flops >= six_nd and est.residency_bytes > 0,
          f"traced FLOPs {trace.dot_flops!r} >= 6ND {six_nd!r}")
    say("dry-run", (
        f"{arch} at (1, 1), {kw['global_batch']} x {kw['seq_len']} tokens, "
        f"one microbatch, lower_cell on fake meta tensors in {took!r} s "
        f"(kernel ops {trace.kernel_calls}): roofline step_time_bound_s "
        f"{rl.step_time_s!r} (compute {rl.compute_s!r}, memory "
        f"{rl.memory_s!r}, collective {rl.collective_s!r}), bottleneck "
        f"{rl.bottleneck}, against the measured step {run['step_s']!r} s "
        f"(ratio {rl.step_time_s / run['step_s']!r}); traced FLOPs "
        f"{trace.dot_flops!r} = {trace.dot_flops / six_nd!r} x 6ND "
        f"({six_nd!r}); analysis.memory.estimate residency "
        f"{est.residency_bytes / gib!r} GiB against the measured peak "
        f"{run['peak']!r} GiB (ratio {est.residency_bytes / gib / run['peak']!r}"
        f"); MemTracker's traced peak {trace.peak_bytes / gib!r} GiB"))


def dryrun_pod_cell() -> None:
    """(c) one full-size cell over a fake group of 256 ranks."""
    t0 = time.perf_counter()
    out = dryrun.run_cell("internlm2-1.8b", TRAIN_4K, "single")
    took = time.perf_counter() - t0
    r = out["roofline"]
    check(r["flops_per_device"] > 0 and out["n_chips"] == 256,
          "the pod cell traced a step over 256 ranks")
    say("dry-run", (
        f"internlm2-1.8b x train_4k x single on the (16, 16) mesh, "
        f"{out['n_chips']} fake ranks, 4 microbatches, traced in {took!r} s: "
        f"per-device residency "
        f"{out['memory_model']['residency_bytes'] / 2**30!r} GiB (traced "
        f"peak {out['memory']['peak_bytes_est'] / 2**30!r} GiB); bottleneck "
        f"{r['bottleneck']} (compute {r['compute_s']!r} s, memory "
        f"{r['memory_s']!r} s, collective {r['collective_s']!r} s); "
        f"collectives {r['collective_counts']}, effective bytes by kind "
        f"{out['trace_raw']['coll_eff_by_kind']}"))


def phase_sharded() -> dict[str, int]:
    """11: the sharded step on the card and the dry-run chain.  Returns
    each kernel's launches in the phase."""
    zero_launches()
    t0 = time.perf_counter()
    counted = sharded_steps()
    took = {"sharded step": time.perf_counter() - t0}
    check(launches() == counted, f"phase 11 launches {launches()} == its "
          f"runs' {counted}")
    dryrun_card_cell()
    took["dry-run (1, 1)"] = time.perf_counter() - t0 - sum(took.values())
    dryrun_pod_cell()
    took["dry-run pod"] = time.perf_counter() - t0 - sum(took.values())
    check(launches() == counted, "the dry-runs launched nothing")
    say("timing", "sharded step and dry-run: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in took.items()) + f"; phase 11 "
        f"{sum(took.values()):.1f} s")
    return counted


# ------------------------------------------------ 12. lint and examples
def phase_lint() -> dict[str, int]:
    """(a) every rule of simlint over every entry on the card.  Returns
    each kernel's launches in it."""
    zero_launches()
    t0 = time.perf_counter()
    with simlint.LintContext(device="cuda") as ctx:
        findings = simlint.run_lint(ctx=ctx)
        stats = simlint.step_stats(ctx)
        peaks = ctx.get("r2_peaks")
    took = time.perf_counter() - t0
    counted = launches()
    for line in simlint.format_report(findings).splitlines():
        print(f"    {line}")
    for rid, spec in sorted(simlint.RULES.items()):
        hits = [f.severity for f in findings if f.rule == rid]
        say("lint", f"{rid} {spec.name}: "
            f"{'FAIL' if 'error' in hits else 'ok'} ({hits.count('error')} "
            f"error(s), {hits.count('warning')} warning(s), "
            f"{hits.count('info')} info)")
    for entry, st in stats.items():
        say("lint", (
            f"{entry}: {st['steps']} batch steps of Fig. 4 (1-DC topology), "
            f"{st['ops_min']}-{st['ops_max']} operators a batch step (mean "
            f"{st['ops_mean']!r}), {st['syncs_per_step']!r} host_any syncs "
            f"a step, {st['driver_syncs']} in the driver's loop tests"))
    say("lint", f"R2: peak memory above the held baseline of chunks of "
        f"{simlint.R2_CHUNK['cuda']} Fig. 9/10 rows at 300 hosts, by chunk "
        f"count: {peaks} bytes")
    check(not any(f.severity == "error" for f in findings),
          "simlint reports no error finding on the card")
    check(counted["sweep"] > 0, "the lint's runs launched the advance sweep")
    say("lint", f"every rule over every entry in {took:.1f} s; launches "
        f"{counted}")
    return counted


def start_twin(name: str, device: str, where: Path) -> tuple:
    """A twin of examples/ as a subprocess: (process, start time, JSON
    path, log path)."""
    out = where / f"{name}.{device}.json"
    log = open(where / f"{name}.{device}.log", "w")
    args = [sys.executable, str(ROOT / "examples_torch" / f"{name}.py"),
            "--device", device, "--json", str(out)]
    if device == "cpu":
        args += EXAMPLE_CPU_ARGS.get(name, [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2")
    proc = subprocess.Popen(args, stdout=log, stderr=subprocess.STDOUT,
                            env=env, cwd=str(ROOT))
    log.close()
    return proc, time.perf_counter(), out, where / f"{name}.{device}.log"


def finish_twins(runs: dict) -> dict:
    """Wait for every twin, each within its timeout; {(name, device):
    (JSON, seconds from its start to its exit)}.  A twin that fails or
    outlives its time fails the phase."""
    ended: dict = {}
    while len(ended) < len(runs):
        for key, (proc, t0, _, _) in runs.items():
            if key in ended:
                continue
            if proc.poll() is not None:
                ended[key] = (proc.returncode, time.perf_counter() - t0)
            elif time.perf_counter() - t0 > EXAMPLE_TIMEOUT:
                proc.kill()
                proc.wait()
                ended[key] = (None, time.perf_counter() - t0)
        time.sleep(0.1)
    done = {}
    for key, (_, _, out, log) in runs.items():
        rc, secs = ended[key]
        if rc != 0:
            print(log.read_text()[-4000:])
        check(rc == 0, f"twin {key[0]} on {key[1]} exited 0 within "
              f"{EXAMPLE_TIMEOUT} s (exit {rc}, {secs:.1f} s)")
        done[key] = (json.loads(out.read_text()), secs)
    return done


def close_to(a, b, rtol: float) -> bool:
    return np.allclose(np.asarray(a, np.float64), np.asarray(b, np.float64),
                       rtol=rtol, atol=0.0)


def hold_twin(name: str, gpu: dict, cpu: dict) -> str:
    """The card's numbers against the CPU run's; returns what was held."""
    tol = EXAMPLE_RTOL
    if name == "quickstart":
        combos = [r[2] for r in gpu["combos"]]
        check([r[:2] for r in gpu["combos"]] == [r[:2] for r in cpu["combos"]]
              and close_to([r[2:] for r in gpu["combos"]],
                           [r[2:] for r in cpu["combos"]], tol)
              and close_to(gpu["campaign_makespans"],
                           cpu["campaign_makespans"], tol),
              "quickstart: the card's turnarounds, makespans and costs equal "
              "the CPU's")
        check([round(x) for x in combos] == [1500, 1800, 1500, 1800]
              and all(abs(r[3] - 2400) < 0.01 for r in gpu["combos"]),
              f"quickstart: Fig. 4's analytic 1,500 / 1,800 s turnaround and "
              f"2,400 s makespan ({combos})")
        return f"turnarounds {combos}, campaign makespans " \
               f"{gpu['campaign_makespans']}"
    if name == "federated_cloud":
        ints = [r[:2] for r in gpu["rows"]]
        check(ints == [r[:2] for r in cpu["rows"]]
              and close_to([r[2:] for r in gpu["rows"]],
                           [r[2:] for r in cpu["rows"]], tol)
              and close_to(gpu["no_federation"], cpu["no_federation"], tol),
              "federated_cloud: migrations, turnarounds, makespans and cuts "
              "equal the CPU's")
        return "Table 1 (peer_bg, migrations, TAT, makespan, TAT cut %, MK " \
               f"cut %): {gpu['rows']}"
    if name == "campaign_search":
        w, cw = gpu["winner"], cpu["winner"]
        check([r[:2] for r in gpu["rungs"]] == [r[:2] for r in cpu["rungs"]]
              and close_to([r[2] for r in gpu["rungs"]],
                           [r[2] for r in cpu["rungs"]], tol)
              and [r[:4] for r in gpu["frontier"]]
              == [r[:4] for r in cpu["frontier"]]
              and close_to([r[4] for r in gpu["frontier"]],
                           [r[4] for r in cpu["frontier"]], tol)
              and {k: v for k, v in w.items() if k != "total_cost"}
              == {k: v for k, v in cw.items() if k != "total_cost"}
              and close_to(w["total_cost"], cw["total_cost"], tol),
              "campaign_search: rungs, frontier and winner equal the CPU's")
        return f"rungs {gpu['rungs']}, winner {w}"
    if name in ("serve_model", "elastic_restart"):
        check(gpu["d_head"] == cpu["d_head"] == 16,
              f"{name}: the reference's smoke model, heads 16 wide "
              f"({gpu['d_head']})")
    if name == "serve_model":
        check(gpu["finished"] == cpu["finished"] and gpu["served"]
              == cpu["served"] == 6 and gpu["makespan"] == cpu["makespan"]
              and gpu["mean_turnaround"] == cpu["mean_turnaround"],
              "serve_model: every request served at the CPU run's steps under "
              "the same policies")
        check(gpu["launches"]["flash"] > 0 and gpu["launches"]["sweep"] > 0,
              f"serve_model launched flash and the sweep ({gpu['launches']})")
        return f"{gpu['served']} requests, finishes {gpu['finished']}, " \
               f"makespan {gpu['makespan']} steps"
    if name == "elastic_restart":
        fails = [f[:3] for f in gpu["failures"]]
        check(gpu["restarts"] == cpu["restarts"] == 2
              and fails == [f[:3] for f in cpu["failures"]]
              and [f[:2] for f in fails] == [[6, 3], [18, 2]]
              and close_to([f[3:] for f in gpu["failures"]],
                           [f[3:] for f in cpu["failures"]], tol)
              and np.isfinite(gpu["final_loss"]),
              "elastic_restart: restarts, resume steps, survivors and plans "
              "equal the CPU's")
        check(gpu["launches"]["flash"] > 0 and gpu["launches"]["flash_bwd"]
              > 0, f"elastic_restart launched the flash forward and "
              f"backward ({gpu['launches']})")
        gap = abs(gpu["final_loss"] - cpu["final_loss"]) / abs(
            cpu["final_loss"])
        return f"restarts {gpu['restarts']}, failures {gpu['failures']}, " \
               f"final loss {gpu['final_loss']!r} (CPU {cpu['final_loss']!r}" \
               f", relative gap {gap!r})"
    # train_100m
    n = len(cpu["losses"])
    gap = max(abs(a - b) / abs(b) for a, b in zip(gpu["losses"][:n],
                                                  cpu["losses"]))
    layers = 12
    check(gpu["n_params"] == cpu["n_params"] and gap <= EXAMPLE_LOSS_RTOL,
          f"train_100m: the first {n} losses {gpu['losses'][:n]} equal the "
          f"CPU's {cpu['losses']} within {EXAMPLE_LOSS_RTOL} (worst "
          f"{gap!r})")
    check(gpu["launches"] == {"flash": layers * gpu["steps_run"],
                              "flash_bwd": layers * gpu["steps_run"]},
          f"train_100m launched flash forward and backward once per layer "
          f"per step ({gpu['launches']})")
    return f"{gpu['n_params']} parameters, loss {gpu['losses'][0]!r} -> " \
           f"{gpu['final_loss']!r} over {gpu['steps_run']} steps, first " \
           f"{n} within {gap!r} of the CPU's"


def phase_lint_examples() -> dict[str, int]:
    """12: simlint (a) and the six twins of examples/ (b), on the CPU
    (started first) and on the card.  Returns each kernel's launches in
    the phase: the lint's and the card's twins' own counts."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(tmp)
        runs = {}
        try:
            for name in EXAMPLES:
                runs[(name, "cpu")] = start_twin(name, "cpu", where)
            lint = phase_lint()
            for name in EXAMPLES:
                runs[(name, "cuda")] = start_twin(name, "cuda", where)
            done = finish_twins(runs)
        finally:
            for proc, *_ in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
    counted = dict(lint)
    for name in EXAMPLES:
        (gpu, g_s), (cpu, c_s) = done[(name, "cuda")], done[(name, "cpu")]
        held = hold_twin(name, gpu, cpu)
        for k, v in gpu.get("launches", {}).items():
            counted[k] += v
        say("examples", f"{name}: card {g_s:.1f} s, CPU {c_s:.1f} s "
            f"(subprocesses, start-up included); {held}; launches "
            f"{gpu.get('launches', {})}")
    say("timing", f"lint and examples: phase 12 {time.perf_counter() - t0:.1f}"
        " s")
    return counted


# ------------------------------------------- 13. every family's smoke model
class Recording:
    """A model whose ``prefill`` and ``decode_step`` keep each call's logits
    (f32, on the host): what ``ServingEngine`` computed, call by call."""

    def __init__(self, model):
        self.model, self.logits = model, []

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, params, batch, max_len):
        logits, caches = self.model.prefill(params, batch, max_len)
        self.logits.append(logits.float().cpu())
        return logits, caches

    def decode_step(self, params, caches, token, pos):
        logits, caches = self.model.decode_step(params, caches, token, pos)
        self.logits.append(logits.float().cpu())
        return logits, caches


def smoke_engine(model, params, device: str) -> tuple[list, list]:
    """``ServingEngine`` over SMOKE_ENGINE's requests: (each model call's
    logits, each request's (finish step, tokens generated))."""
    e = SMOKE_ENGINE
    rec = Recording(model)
    eng = ServingEngine(rec, params, n_slots=e["n_slots"],
                        max_len=e["max_len"], device=device)
    rng = np.random.default_rng(13)
    for n in e["prompts"]:
        eng.submit(rng.integers(0, model.cfg.vocab, size=n),
                   max_new_tokens=e["new_tokens"])
    eng.run_until_drained()
    check(all(r.done and r.generated == e["new_tokens"]
              for r in eng.requests), f"{model.cfg.name} on {device}: every "
          f"request served its {e['new_tokens']} tokens")
    return rec.logits, [(r.finish_time, r.generated) for r in eng.requests]


def smoke_batch(cfg) -> tuple[dict, int]:
    """The prefill batch of SMOKE_GENERATE for ``cfg``'s family (frames for
    encdec; patch embeddings and M-RoPE positions for vlm) and the position
    of the first decode step."""
    g = SMOKE_GENERATE
    rng = np.random.default_rng(14)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, size=(g["batch"], g["prompt"])))}
    start = g["prompt"]
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (g["batch"], cfg.encoder.n_ctx, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        n = g["patches"]
        batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
            (g["batch"], n, cfg.d_model)).astype(np.float32))
        batch["positions"] = mrope_positions(n, g["grid"], g["prompt"]).expand(
            3, g["batch"], -1).contiguous()
        start += n
    return batch, start


def smoke_serve(cfg, model, cpu, gpu) -> str:
    """f32: the engine on both devices (engine families) or greedy
    ``Model.prefill`` / ``decode_step`` (encdec, vlm), every call's logits
    within 1e-3 and the same tokens (``hold_logits``, as phase 7); bf16: the engine on the card
    (engine families), then prefill and decode steps fed the CPU's greedy
    tokens on both devices, every call's logits within SMOKE_BF16_RTOL
    relative.  Returns what was held."""
    label = f"{cfg.name} {cfg.dtype}"
    engine_family = cfg.family not in ("encdec", "vlm")
    said = []
    if engine_family:
        card, card_done = smoke_engine(model, gpu, "cuda")
        check(all(bool(x.isfinite().all()) for x in card),
              f"{label}: the card engine's logits finite")
        said.append(f"engine on the card: {len(card)} calls, finishes "
                    f"{card_done}")
    if cfg.dtype == "float32":
        if engine_family:
            host, host_done = smoke_engine(model, cpu, "cpu")
            check(host_done == card_done and len(host) == len(card),
                  f"{label}: the card engine's finishes {card_done} == the "
                  f"CPU's {host_done}")
            worst, tokens = hold_logits(label, {"cuda": card, "cpu": host})
        else:
            batch, start = smoke_batch(cfg)
            g = SMOKE_GENERATE
            runs, _, _ = parity_runs(model, cpu, gpu, batch,
                                     start + g["steps"] + 1, g["steps"],
                                     start)
            worst, tokens = hold_logits(label, runs)
        said.append(f"every call's logits within 1e-3 of the "
                    f"CPU's (max |err| {worst!r}) and the same greedy tokens "
                    f"({len(tokens)} calls)")
        return "; ".join(said)
    batch, start = smoke_batch(cfg)
    g = SMOKE_GENERATE
    max_len = start + g["steps"] + 1
    with torch.no_grad():
        host = greedy_run(model, cpu, batch, max_len, g["steps"], start)[0]
        tokens = [x.argmax(-1)[:, None] for x in host[:-1]]
        card = greedy_run(model, gpu, {k: v.cuda() for k, v in batch.items()},
                          max_len, g["steps"], start, tokens)[0]
    gaps = [float((a.float().cpu() - b.float()).norm() / b.float().norm())
            for a, b in zip(card, host)]
    check(len(card) == len(host) and max(gaps) < SMOKE_BF16_RTOL,
          f"{label}: every call's logits within {SMOKE_BF16_RTOL} relative "
          f"of the CPU's ({gaps})")
    said.append(f"prefill and {g['steps']} decode steps fed the CPU's greedy "
                f"tokens: logits within {max(gaps)!r} relative of the CPU's "
                f"(limit {SMOKE_BF16_RTOL})")
    return "; ".join(said)


def smoke_train_runs(cfg, model, cpu) -> dict:
    """{device: (losses, gradient norms)} of SMOKE_TRAIN's steps from the
    CPU-drawn weights: ``run_training`` resuming the step-0 checkpoint of
    those weights (the Markov pipeline's tokens, identical on both
    devices), or for encdec and vlm ``make_train_step`` on one batch."""
    t = SMOKE_TRAIN
    runs = {}
    if cfg.family in ("encdec", "vlm"):
        batch, _ = smoke_batch(cfg)
        rng = np.random.default_rng(15)
        S = batch["tokens"].shape[1] + (
            batch["frontend_embeds"].shape[1] if cfg.family == "vlm" else 0)
        labels = rng.integers(0, cfg.vocab, size=(batch["tokens"].shape[0], S))
        if cfg.family == "vlm":
            labels[:, :batch["frontend_embeds"].shape[1]] = -100
        batch["labels"] = torch.from_numpy(labels)
        for dev in ("cpu", "cuda"):
            params = tree.map_tree(lambda x: x.to(dev), cpu)
            opt_state = adamw_init(params)
            step_fn = make_train_step(model, OptConfig(
                lr=t["lr"], warmup_steps=5, total_steps=t["steps"]))
            b = {k: v.to(dev) for k, v in batch.items()}
            losses, norms = [], []
            for _ in range(t["steps"]):
                params, opt_state, metrics = step_fn(params, opt_state, b)
                losses.append(float(metrics["loss"]))
                norms.append(float(metrics["grad_norm"]))
            runs[dev] = (losses, norms)
        return runs
    for dev in ("cpu", "cuda"):
        with tempfile.TemporaryDirectory() as d:
            ckpt_save(d, 0, (cpu, adamw_init(cpu)))
            out = run_training(cfg, steps=t["steps"],
                               global_batch=t["global_batch"],
                               seq_len=t["seq_len"], lr=t["lr"], ckpt_dir=d,
                               ckpt_every=0, log_every=0, device=dev)
        runs[dev] = (out["losses"], out["grad_norms"])
    return runs


def smoke_train(cfg, model, cpu) -> str:
    """Losses (and in f32 gradient norms) on the card against the CPU's:
    f32 within SMOKE_F32_TRAIN_RTOL, bf16 losses within SMOKE_BF16_RTOL."""
    label = f"{cfg.name} {cfg.dtype}"
    runs = smoke_train_runs(cfg, model, cpu)
    (l0, n0), (l1, n1) = runs["cpu"], runs["cuda"]
    check(all(np.isfinite(l1)) and all(np.isfinite(n1)),
          f"{label}: the card's losses {l1} and gradient norms {n1} finite")
    if cfg.dtype == "float32":
        check(close_to(l1, l0, SMOKE_F32_TRAIN_RTOL)
              and close_to(n1, n0, SMOKE_F32_TRAIN_RTOL),
              f"{label}: losses {l1} and gradient norms {n1} within "
              f"{SMOKE_F32_TRAIN_RTOL} of the CPU's {l0}, {n0}")
        limit = SMOKE_F32_TRAIN_RTOL
    else:
        check(close_to(l1, l0, SMOKE_BF16_RTOL),
              f"{label}: losses {l1} within {SMOKE_BF16_RTOL} of the CPU's "
              f"{l0}")
        limit = SMOKE_BF16_RTOL
    gap = max(abs(a - b) / abs(b) for a, b in zip(l1, l0))
    how = ("make_train_step" if cfg.family in ("encdec", "vlm")
           else "run_training")
    return (f"{how}, {len(l1)} steps: losses {l1} (CPU {l0}, worst relative "
            f"gap {gap!r}, limit {limit}), gradient norms {n1} (CPU {n0})")


def phase_smoke_zoo() -> dict[str, int]:
    """13: ``get_config(arch, smoke=True)`` of every arch of the registry,
    in f32 and bf16, served and trained on the card and held to the same
    config's CPU run.  Every attention arch must launch the flash forward
    and backward, the SSM archs the SSD kernel.  Returns each kernel's
    launches in the phase."""
    t0 = time.perf_counter()
    total = {k: 0 for k in launches()}
    for arch in ARCH_IDS:
        before = launches()
        for dtype in ("float32", "bfloat16"):
            cfg = get_config(arch, smoke=True, dtype=dtype)
            model = build_model(cfg)
            cpu = model.init(torch.Generator().manual_seed(0))
            gpu = tree.map_tree(lambda x: x.to("cuda"), cpu)
            start = launches()
            served = smoke_serve(cfg, model, cpu, gpu)
            trained = smoke_train(cfg, model, cpu)
            count = {k: v - start[k] for k, v in launches().items()}
            say("smoke zoo", (
                f"{arch} smoke ({cfg.family}, {cfg.n_layers} layers, "
                f"d_model {cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
                f"of D {cfg.d_head}) {dtype}: served: {served}; trained: "
                f"{trained}; launches {count}"))
            del gpu
        count = {k: v - before[k] for k, v in launches().items()}
        for k, v in count.items():
            total[k] += v
        attn = (cfg.family == "encdec" or mixers(cfg, "attn") > 0)
        ssm_layers = 0 if cfg.family == "encdec" else mixers(cfg, "ssm")
        check((count["flash"] > 0 and count["flash_bwd"] > 0) == attn,
              f"{arch} smoke: flash forward {count['flash']} and backward "
              f"{count['flash_bwd']} launches, {'some' if attn else 'none'} "
              "wanted")
        check((count["ssd"] > 0) == (count["ssd_bwd"] > 0) == (ssm_layers > 0),
              f"{arch} smoke: {count['ssd']} SSD launches and "
              f"{count['ssd_bwd']} backward for {ssm_layers} SSM layers")
    torch.cuda.empty_cache()
    say("timing", f"smoke zoo: phase 13 {time.perf_counter() - t0:.1f} s")
    return total


def wide_launches() -> dict[str, int]:
    fwd = flash_attention.flash_attention_cuda
    bwd = flash_attention.flash_attention_bwd_cuda
    return {"native": fwd.native_launches, "wide": fwd.wide_launches,
            "padded": fwd.padded_launches,
            "native_bwd": bwd.native_launches, "wide_bwd": bwd.wide_launches,
            "padded_bwd": bwd.padded_launches}


def phase_wide_heads() -> tuple[dict[str, int], dict[str, int]]:
    """14: the smoke models of WIDE_HEAD_ARCHS with their heads widened by
    ``dataclasses.replace`` to each of WIDE_HEAD_DIMS (256: the whole-width
    kernels in both dtypes; 512: the column slices in bf16, the f32
    whole-width kernels in f32; 20: padded to 24), in f32 and bf16, from
    one CPU draw of the weights: served and trained for 3 steps on the card
    and on the CPU, and held to the CPU's runs as phase 13 holds the smoke
    zoo.  Every flash forward and backward launch of a model is the kind
    its width and dtype ask for (native past 128 in f32 and at 256 in bf16,
    wide at bf16 512, padded at 20) and their plain versions run 0 times on
    the card.  Returns the flash launches, native, wide and padded among
    them, and the f32 models' native forward and backward launches (the f32
    whole-width kernels')."""
    t0 = time.perf_counter()
    start = {**launches(), **wide_launches()}
    f32_native = {"fwd": 0, "bwd": 0}
    with PlainAttentionOnCard() as plain:
        for arch in WIDE_HEAD_ARCHS:
            for d_head in WIDE_HEAD_DIMS:
                for dtype in ("float32", "bfloat16"):
                    cfg = dataclasses.replace(
                        get_config(arch, smoke=True, dtype=dtype),
                        d_head=d_head)
                    model = build_model(cfg)
                    cpu = model.init(torch.Generator().manual_seed(0))
                    gpu = tree.map_tree(lambda x: x.to("cuda"), cpu)
                    before = {**launches(), **wide_launches()}
                    served = smoke_serve(cfg, model, cpu, gpu)
                    trained = smoke_train(cfg, model, cpu)
                    count = {k: v - before[k] for k, v in
                             {**launches(), **wide_launches()}.items()}
                    kind = ("padded" if d_head <= 128 else "native"
                            if flash_attention.native(d_head,
                                                      getattr(torch, dtype))
                            else "wide")
                    check(count[kind] == count["flash"] > 0
                          and count[f"{kind}_bwd"] == count["flash_bwd"] > 0,
                          f"{arch} smoke, D {d_head}, {dtype}: every flash "
                          f"launch {kind} ({count})")
                    if kind == "native" and dtype == "float32":
                        f32_native["fwd"] += count["native"]
                        f32_native["bwd"] += count["native_bwd"]
                    say("wide heads", (
                        f"{arch} smoke ({cfg.n_layers} layers, d_model "
                        f"{cfg.d_model}, {cfg.n_heads}/{cfg.n_kv_heads} heads "
                        f"of D {cfg.d_head}) {dtype}: served: {served}; "
                        f"trained: {trained}; launches {count}"))
                    del gpu
    check(plain.calls == 0, f"phase 14: the flash kernels' plain versions "
          f"ran {plain.calls} times on the card")
    count = {k: v - start[k] for k, v in
             {**launches(), **wide_launches()}.items()}
    torch.cuda.empty_cache()
    say("timing", f"wide heads: phase 14 {time.perf_counter() - t0:.1f} s")
    return count, f32_native


def main() -> None:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    took = {}
    t0 = time.perf_counter()
    phase_build()
    took["build"] = time.perf_counter() - t0
    sweep_record = phase_sweep_kernel()
    flash_record, native_record, wide_record, f32_record = \
        phase_flash_kernel()
    (flash_bwd_record, native_bwd_record, wide_bwd_record,
     f32_bwd_record) = phase_flash_bwd_kernel()
    ssd_record = phase_ssd_kernel()
    ssd_bwd_record = phase_ssd_bwd_kernel()
    took["kernels"] = time.perf_counter() - t0 - sum(took.values())

    vm_update.advance_sweep_cuda.launches = 0
    solo, steps = phase_anchors()
    campaign_steps, batch, batch_res = phase_campaign(solo)
    steps += campaign_steps
    took["anchors and campaign"] = time.perf_counter() - t0 - sum(took.values())
    steps += phase_extensions(solo, (batch, batch_res))
    phase4 = result_to_numpy(batch_res)
    del batch, batch_res
    took["extensions"] = time.perf_counter() - t0 - sum(took.values())
    steps += phase_network(solo)
    took["network and campaigns"] = (time.perf_counter() - t0
                                     - sum(took.values()))
    sweeps = vm_update.advance_sweep_cuda.launches
    check(sweeps > 0, "the main path launched the advance-sweep kernel")
    check(sweeps == steps,
          f"one advance-sweep launch per batch step ({sweeps} vs {steps})")
    say("proof", f"advance_sweep kernel launched {sweeps} times over "
        f"phases 3-4c, one per batch step")

    flash_attention.flash_attention_bwd_cuda.launches = 0
    ssd_scan.ssd_scan_bwd_cuda.launches = 0
    remat_calls = lm.remat_call.calls
    flash_launches = phase_serving()
    took["serving"] = time.perf_counter() - t0 - sum(took.values())
    phase_zoo()
    took["model zoo"] = time.perf_counter() - t0 - sum(took.values())
    phase_parity()
    took["parity"] = time.perf_counter() - t0 - sum(took.values())
    check(flash_attention.flash_attention_bwd_cuda.launches == 0
          and ssd_scan.ssd_scan_bwd_cuda.launches == 0
          and lm.remat_call.calls == remat_calls,
          "serving (phases 6-7) launched no flash or SSD backward and "
          "checkpointed nothing")
    say("proof", "phases 6-7 (serving every family, parity) launched the "
        "flash and SSD backward 0 times and made 0 checkpoints")
    ssd_launches, ssd_bwd_launches = phase_train()
    took["train"] = time.perf_counter() - t0 - sum(took.values())
    zero_launches()
    dense_fwd, dense_bwd = phase_dense_train()
    counted = launches()
    check(counted["flash"] == dense_fwd > 0 and counted["flash_bwd"]
          == dense_bwd > 0, f"phase 8b launched the flash forward "
          f"{counted['flash']} and backward {counted['flash_bwd']} times, "
          f"as its runs counted ({dense_fwd}, {dense_bwd})")
    say("proof", f"phase 8b launched the flash forward {counted['flash']} "
        f"and backward {counted['flash_bwd']} times")
    took["dense train"] = time.perf_counter() - t0 - sum(took.values())
    phase_train_parity()
    took["train parity"] = time.perf_counter() - t0 - sum(took.values())
    tenth = phase_elastic_mesh(phase4)
    took["elastic and mesh"] = time.perf_counter() - t0 - sum(took.values())
    say("proof", f"phase 10 launched the SSD kernel {tenth['ssd']} (its "
        f"backward {tenth['ssd_bwd']}), the "
        f"advance sweep {tenth['sweep']}, the flash forward "
        f"{tenth['flash']} and backward {tenth['flash_bwd']} times")
    eleventh = phase_sharded()
    took["sharded step and dry-run"] = (time.perf_counter() - t0
                                        - sum(took.values()))
    say("proof", f"phase 11 launched the SSD kernel {eleventh['ssd']} "
        f"(its backward {eleventh['ssd_bwd']}), the "
        f"flash forward {eleventh['flash']} and backward "
        f"{eleventh['flash_bwd']} times, every forward through local_map")
    twelfth = phase_lint_examples()
    took["lint and examples"] = time.perf_counter() - t0 - sum(took.values())
    say("proof", f"phase 12 (the lint and the twins on the card) launched "
        f"the advance sweep {twelfth['sweep']}, the flash forward "
        f"{twelfth['flash']} and backward {twelfth['flash_bwd']} and the SSD "
        f"kernel {twelfth['ssd']} times")
    zero_launches()
    thirteenth = phase_smoke_zoo()
    check(launches() == thirteenth, f"phase 13 launches {launches()} == its "
          f"runs' {thirteenth}")
    took["smoke zoo"] = time.perf_counter() - t0 - sum(took.values())
    say("proof", f"phase 13 (every family's smoke model, 16-wide heads) "
        f"launched the flash forward {thirteenth['flash']} and backward "
        f"{thirteenth['flash_bwd']} and the SSD kernel {thirteenth['ssd']} "
        f"(its backward {thirteenth['ssd_bwd']}) times")
    zero_launches()
    fourteenth, f32_fourteenth = phase_wide_heads()
    check({k: v for k, v in {**launches(), **wide_launches()}.items()
           if k in fourteenth} == fourteenth,
          f"phase 14 launches {launches()} {wide_launches()} == its runs' "
          f"{fourteenth}")
    took["wide heads"] = time.perf_counter() - t0 - sum(took.values())
    say("proof", f"phase 14 (smoke models with heads of 256, 512 and 20) "
        f"launched the flash forward {fourteenth['flash']} "
        f"({fourteenth['native']} native, {f32_fourteenth['fwd']} of them "
        f"f32, {fourteenth['wide']} wide, {fourteenth['padded']} padded) "
        f"and backward {fourteenth['flash_bwd']} "
        f"({fourteenth['native_bwd']} native, {f32_fourteenth['bwd']} of "
        f"them f32, {fourteenth['wide_bwd']} wide, "
        f"{fourteenth['padded_bwd']} padded) times, their plain versions 0 "
        f"times on the card")
    say("timing", ", ".join(f"{k} {v:.1f} s" for k, v in took.items()))

    kernels = [{
        "name": "advance_sweep",
        "route": "cuda",
        "source": "src/repro_torch/csrc/vm_update.cu",
        "replaces": "src/repro/kernels/vm_update.py:123",
        "launches": (sweeps + tenth["sweep"] + eleventh["sweep"]
                     + twelfth["sweep"] + thirteenth["sweep"]),
        **sweep_record,
        "library_ms": None,
    }, {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": (flash_launches + tenth["flash"] + eleventh["flash"]
                     + twelfth["flash"] + thirteenth["flash"]
                     + fourteenth["flash"]),
        **flash_record,
    }, {
        "name": "flash_attention_native",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99 (bf16 head "
                    "widths 136-256)",
        "launches": fourteenth["native"] - f32_fourteenth["fwd"],
        **native_record,
    }, {
        "name": "flash_attention_f32_256",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99 (f32 head "
                    "widths past 128)",
        "launches": f32_fourteenth["fwd"],
        **f32_record,
    }, {
        "name": "flash_attention_wide",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99 (bf16 head "
                    "widths past 256)",
        "launches": fourteenth["wide"],
        **wide_record,
    }, {
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:40 flash_xla (gradient by "
                    "jax.grad; no Pallas kernel)",
        "launches": (counted["flash_bwd"] + tenth["flash_bwd"]
                     + eleventh["flash_bwd"] + twelfth["flash_bwd"]
                     + thirteenth["flash_bwd"] + fourteenth["flash_bwd"]),
        **flash_bwd_record,
    }, {
        "name": "flash_attention_bwd_native",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:40 flash_xla (gradient by "
                    "jax.grad; bf16 head widths 136-256)",
        "launches": fourteenth["native_bwd"] - f32_fourteenth["bwd"],
        **native_bwd_record,
    }, {
        "name": "flash_attention_bwd_f32_256",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:40 flash_xla (gradient by "
                    "jax.grad; f32 head widths past 128)",
        "launches": f32_fourteenth["bwd"],
        **f32_bwd_record,
    }, {
        "name": "flash_attention_bwd_wide",
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/attention.py:40 flash_xla (gradient by "
                    "jax.grad; bf16 head widths past 256)",
        "launches": fourteenth["wide_bwd"],
        **wide_bwd_record,
    }, {
        "name": "ssd_scan",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:81",
        "launches": (ssd_launches + tenth["ssd"] + eleventh["ssd"]
                     + twelfth["ssd"] + thirteenth["ssd"]),
        **ssd_record,
    }, {
        "name": "ssd_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/ssm.py:124 ssd_chunked_ref (gradient "
                    "by jax.grad; no Pallas kernel)",
        "launches": (ssd_bwd_launches + tenth["ssd_bwd"]
                     + eleventh["ssd_bwd"] + twelfth["ssd_bwd"]
                     + thirteenth["ssd_bwd"]),
        **ssd_bwd_record,
    }]
    print(CARD)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
