"""Count, layer by layer, the tokens the program and the reference route
differently in the forward of a training cell's first checked step.

    python bench/route_flips.py --workload <cell> --seed <n>

Run from the root of a checkout, on a card.  The same weights and rows
as the cell's first step go through the program's forward (its own
dtype, no grad) and the float32 reference's; each MoE layer's top-k
choice is recorded on both sides, and for each layer the line gives the
tokens whose top-k sets differ (``any``), those whose set of held
experts differs (``held``: an assignment moved between a held expert
and one held elsewhere, or between two held ones), and the held
assignments on each side.  The two sides' hidden states part by the
program's rounding, more with depth, so a near-tie of the k-th and
(k+1)-th router probability can fall either way.  Prints one JSON line.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def held_onehot(idx, E: int, held: int):
    """[T, held] 0/1: which held experts each token's top-k names."""
    import torch
    oh = torch.zeros(idx.shape[0], E, dtype=torch.int8, device=idx.device)
    return oh.scatter_(1, idx, 1)[:, :held]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from bench.lib import spec, traffic
    from bench.reference.common import Numerics, strict_float32
    from repro_torch.models import build
    from repro_torch.models import layers
    if not torch.cuda.is_available():
        print("route_flips: needs a CUDA card", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, ROOT)
    config, m = cell.config, cell.config["model"]
    ref = spec.reference(config)
    E, k = m["moe_num_experts"], m["moe_top_k"]
    held = m.get("moe_experts_held") or E
    batch = traffic.train_feed(cell.traffic, m["vocab_size"], args.seed,
                               device)(0)
    params = ref.make_params(m, args.seed, device)
    prog, ours = [], []

    route = layers._route

    def record_program(p, x, top_k):
        out = route(p, x, top_k)
        prog.append(out[1].reshape(-1, top_k))
        return out
    layers._route = record_program
    try:
        with torch.no_grad():
            build(spec.model_config(config)).loss(params, batch)
    finally:
        layers._route = route
    torch.cuda.empty_cache()

    moe = ref._moe

    def record_reference(m_, nm, h, router, *rest):
        probs = torch.softmax(nm.mm(h.reshape(-1, h.shape[-1]), router), -1)
        ours.append(probs.topk(k, dim=-1)[1])
        return moe(m_, nm, h, router, *rest)
    ref._moe = record_reference
    try:
        with torch.no_grad(), strict_float32():
            ref.loss(m, params, batch["tokens"], batch["labels"], Numerics())
    finally:
        ref._moe = moe
    layers_out = []
    for a, b in zip(prog, ours):
        full_a = held_onehot(a, E, E)
        full_b = held_onehot(b, E, E)
        ha, hb = full_a[:, :held], full_b[:, :held]
        layers_out.append({
            "any": int((full_a != full_b).any(dim=1).sum()),
            "held": int((ha != hb).any(dim=1).sum()),
            "held_assignments": [int(ha.sum()), int(hb.sum())]})
    print(json.dumps({"workload": args.workload, "seed": args.seed,
                      "tokens": int(prog[0].shape[0]) if prog else 0,
                      "layers": layers_out,
                      "card": torch.cuda.get_device_name(device)}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
