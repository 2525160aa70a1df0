"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b

trains random-weight ``--arch`` at full width on one GPU, 2 sequences of
1,024 tokens a step (what one H100 holds with f32 master parameters and
AdamW moments).  ``--offload`` runs the step through the offload
compiler (``--offload-mode`` picks its decision backend) and prints the
plans' decisions.  The step is compiled (``compile_train_step``): the
launcher prints ``train_traces``, the first step's warm call and capture
seconds and the graph pool's bytes.  ``--local`` trains the reduced
config on 4 x 128 tokens instead; ``--device cpu`` runs the plain
PyTorch path on the CPU (the kernels need the GPU).  One device, no
mesh.  Checkpoints every 50 steps go to ``--ckpt-dir`` (default: a
directory under the system's temporary directory, printed at start),
and a run resumes from the newest one there, as the reference's
launcher does.  ``MPU_PLAN_CACHE`` names a persistent plan store that
every offloaded plan of the run is read from and written to.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import (
    ARCH_IDS,
    ShapeConfig,
    TrainConfig,
    get_config,
    reduced,
)
from repro_torch.core.offload import bwd_plan_stats
from repro_torch.core.policy import PLANNER_MODES, OffloadPolicy
from repro_torch.train import train


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--local", action="store_true",
                    help="train the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--offload", action="store_true",
                    help="run the train step through the offload compiler")
    ap.add_argument("--offload-mode", default=None,
                    choices=list(PLANNER_MODES),
                    help="offload decision backend (implies --offload)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_launch_train"),
                    help="checkpoint directory (resumed from when it "
                         "holds a checkpoint)")
    args = ap.parse_args(argv)
    print(f"checkpoints: {args.ckpt_dir} (every 50 steps; resumed from "
          f"when present); plan store: "
          f"{os.environ.get('MPU_PLAN_CACHE') or 'none (MPU_PLAN_CACHE)'}")

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced(cfg)
        shape = ShapeConfig("local", 128, 4, "train")
    else:
        shape = ShapeConfig("train_1k", 1024, 2, "train")
    offload = args.offload or args.offload_mode is not None
    tcfg = TrainConfig(total_steps=args.steps, checkpoint_every=50,
                       checkpoint_dir=args.ckpt_dir, offload=offload,
                       offload_policy=OffloadPolicy(mode=args.offload_mode)
                       if args.offload_mode else None)
    held = []
    _, history = train(cfg, shape, tcfg, device=args.device, log_every=1,
                       on_step=held.append)
    if not history:
        print(f"nothing to train: {args.ckpt_dir} holds step "
              f"{args.steps - 1} or later")
        return
    print(f"trained {len(history)} steps ({history[0]['step']}.."
          f"{history[-1]['step']}): loss {history[0]['loss']:.4f} -> "
          f"{history[-1]['loss']:.4f}")
    step = held[0]
    graph = step.graph
    built = "eager (no CUDA graph on this device)" if graph is None else (
        f"warm step + capture {graph.seconds:.1f} s (warm "
        f"{graph.warm_seconds:.1f} s), graph pool "
        f"{graph.memory['reserved'][1] - graph.memory['reserved'][0]} bytes")
    print(f"compiled step: train_traces {step.counters['train_traces']}, "
          f"{built}")
    if offload:
        print(f"loss plans: {step.stats}")
        print(f"backward plans: {bwd_plan_stats()}")
    print("done")


if __name__ == "__main__":
    main()
