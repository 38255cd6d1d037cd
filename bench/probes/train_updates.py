"""How much of each parameter the program's first AdamW steps move.

    python3 bench/probes/train_updates.py --layers 14 --dtype bfloat16 --seeds 1,2
    python3 bench/probes/train_updates.py --layers 4 --dtype float32 --seeds 1,2

Builds qwen3-14b (``bench/configs/qwen3-14b.json``) at ``--layers`` of
its 40 layers with the benchmark's seeded weights, takes three steps of
the program's ``train.train_step.make_train_step`` with its default
``TrainConfig`` (AdamW, lr 3e-4 after 100 warm-up steps) on 2 x 4,096
seeded tokens, and prints for each kind of leaf the share of elements
that moved and the change's norm against the leaf's, beside the least
change AdamW's first steps ask of every element whose gradient is not
zero: the learning rate of those steps, 3e-6 to 9e-6.  The probe stands
for the training cell that the benchmark leaves out (PERF.md, Open
questions)."""
import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

from benchlib import guard  # noqa: E402

guard.prepare_process()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=14)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--seeds", default="1,2")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=4096)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args()
    import torch

    from benchlib import program
    from benchlib import weights as W
    from benchlib.shape import Shape
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.train_step import TrainConfig, make_train_step
    conf = json.loads((HERE / "configs" / "qwen3-14b.json").read_text())
    conf.update(num_hidden_layers=args.layers, dtype=args.dtype)
    s = Shape.from_config(conf)
    dev = torch.device(args.device)
    for seed in (int(x) for x in args.seeds.split(",")):
        cfg, model = program.build_model(s, seed, dev)
        model.requires_grad_()
        tcfg = TrainConfig()
        opt = adamw_init(dict(model.named_parameters()), tcfg.optimizer)
        step = make_train_step(cfg, tcfg)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        losses = []
        for _ in range(3):
            toks = torch.randint(0, s.vocab, (args.batch, args.seq + 1),
                                 generator=gen, device=dev)
            model, opt, m = step(model, opt, {"tokens": toks[:, :-1],
                                              "labels": toks[:, 1:]})
            losses.append(float(m["loss"]))
        del opt
        moved, norm, base = (defaultdict(float) for _ in range(3))
        count = defaultdict(int)
        with torch.no_grad():
            layers = [(W.TOP, model)] + list(enumerate(model.blocks))
            for layer, mod in layers:
                w0 = W.draw_top(s, seed, dev) if layer == W.TOP \
                    else W.draw_layer(s, seed, layer, dev)
                for name, p0 in w0.items():
                    p = getattr(mod, name).detach()
                    d = p.float() - p0.float()
                    moved[name] += float((d != 0).sum())
                    count[name] += p.numel()
                    norm[name] += float(d.square().sum())
                    base[name] += float(p0.float().square().sum())
                del w0
        print(json.dumps({
            "seed": seed, "dtype": args.dtype, "layers": args.layers,
            "losses": losses, "card": torch.cuda.get_device_name(dev)
            if dev.type == "cuda" else "cpu",
            "moved_share": {k: moved[k] / count[k] for k in moved},
            "change_over_norm": {k: (norm[k] / base[k]) ** 0.5
                                 if base[k] else None for k in norm}}),
            flush=True)
        del model
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
