"""Fault tolerance demo: train with injected node failures; the coordinator
restores from the latest checkpoint, evaluates its CloudSim restart plan,
and finishes the job — the PyTorch port's twin of
``examples/elastic_restart.py``.

    python examples_torch/elastic_restart.py [--device cpu]

The smoke internlm2 model, the reference's own (16-wide heads), trains
for 30 steps with checkpoints every 6; failures are injected at steps 9
and 20, each restart resumes from the latest checkpoint and plans with two
``simulate`` runs.  The weights come from a seeded ``torch.Generator``, so
the losses are the port's own.
``--device`` defaults to the GPU; without one, pass ``--device cpu``.
``--json PATH`` also writes the printed numbers.
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import resolve_device  # noqa: E402
from repro_torch.kernels import flash_attention, vm_update  # noqa: E402
from repro_torch.launch.elastic import ElasticRunner  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("internlm2-1.8b", smoke=True)
    with tempfile.TemporaryDirectory() as d:
        runner = ElasticRunner(cfg, d, steps=30, global_batch=4, seq_len=32,
                               ckpt_every=6, n_workers=4, device=dev)
        out = runner.run(fail_at_steps=[9, 20])
    rec = {"restarts": out["restarts"], "failures": [], "d_head": cfg.d_head,
           "final_loss": out["result"]["final_loss"],
           "losses": out["result"]["losses"],
           "launches": {
               "flash": flash_attention.flash_attention_cuda.launches,
               "flash_bwd": flash_attention.flash_attention_bwd_cuda.launches,
               "sweep": vm_update.advance_sweep_cuda.launches}}
    print(f"restarts: {out['restarts']}")
    for e in out["events"]:
        if e["kind"] == "failure":
            plan = e["plan"]
            rec["failures"].append([e["resume_step"], e["survivors"],
                                    plan["choice"],
                                    plan["finish_on_survivors_s"],
                                    plan["wait_for_repair_s"]])
            print(f"  failure -> resume@{e['resume_step']} on "
                  f"{e['survivors']} workers; plan={plan['choice']} "
                  f"(survivors {plan['finish_on_survivors_s']:.0f}s vs "
                  f"repair {plan['wait_for_repair_s']:.0f}s)")
    print(f"final loss: {out['result']['final_loss']:.4f}")
    if args.json:
        Path(args.json).write_text(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
