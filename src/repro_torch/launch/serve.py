"""Serving launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b

serves random-weight ``--arch`` at full width on the GPU through the
paged ``Engine``.  ``--offload`` runs the decode step through the
offload compiler (``--offload-mode`` picks its decision backend) and
prints the plan's decisions.  ``--local`` serves the reduced config
instead; ``--device cpu`` runs the plain PyTorch path on the CPU (the
kernels need the GPU).  One device, no mesh.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config, reduced
from repro_torch.core.policy import PLANNER_MODES, OffloadPolicy
from repro_torch.models import build_model
from repro_torch.serve import Engine, Request


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b", choices=list(ARCH_IDS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--local", action="store_true",
                    help="serve the reduced same-family config")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--offload", action="store_true",
                    help="run the decode step through the offload compiler")
    ap.add_argument("--offload-mode", default=None,
                    choices=list(PLANNER_MODES),
                    help="offload decision backend (implies --offload)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.local:
        cfg = reduced(cfg)
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    policy = (OffloadPolicy(mode=args.offload_mode)
              if args.offload_mode else None)
    engine = Engine(cfg, params, slots=4, max_len=128, device=args.device,
                    offload=args.offload, offload_policy=policy)
    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab_size, size=8),
                    max_new_tokens=8, rid=i)
            for i in range(args.requests)]
    done = engine.generate(reqs)
    total = sum(len(c.tokens) for c in done.values())
    print(f"served {len(reqs)} requests / {total} tokens")
    print(f"kernel launches: {engine.serve_stats['kernel_launches']}")
    if engine.offload:
        print(f"offload plan cache: {engine.offload_stats}")
        print(engine.explain_decode())


if __name__ == "__main__":
    main()
