"""How many blocks should share a row tile's 27 offsets in the sparse-conv
kernels A and H: kernel A timed at each published conv shape for each
offset split, in its f32 form and in its bf16 form (the split is picked
per form); and over how many blocks the weight gradients D and I
should split their rows: kernel D timed at the same shapes for each
row-split plan of `ops.sparse_conv_kernel.dw_row_splits` (`waves`
rounds of the blocks the card holds at once, each split at least
`min_rows` rows), in its f32 form and in its bf16 form (the plan is
picked per form).

    python -m vdetr_tpu_torch.tools.conv_splits [--only conv,conv_bf16,dw,dw_bf16]

The shapes are the published model's (`VDETRConfig()`, one synthetic
scene, seeded random features and weights): the stem (3 -> 64, stride 2),
the submanifold convs of stages 1-4 (64, 128, 256, 512 channels) and the
stride-2 conv into stage 2 (64 -> 128). Per shape and split: ms per
launch (CUDA events, mean of 20) and the error against the plain version
relative to max(1, max|ref|); the split `ops.sparse_conv_kernel.
conv_splits` picks is marked. `--only` names the sweeps to run (all
four by default). Needs the card.
"""

from __future__ import annotations

import torch

SPLITS = (1, 2, 3, 6, 9, 27)
# (input level, output level, C_in, C_out) in chip_smoke.level_grids' list
SHAPES = ((0, 1, 3, 64), (2, 2, 64, 64), (2, 3, 64, 128), (3, 3, 128, 128),
          (4, 4, 256, 256), (5, 5, 512, 512))


def sweep(reps: int = 20, bf16: bool = False):
    """Per shape (label, {splits: (ms, relative error)}, chosen split) of
    kernel A's f32 form, or of its bf16 form (`bf16`: bf16 features and
    weights, the stem's channels padded to 8)."""
    import chip_smoke as cs
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (conv_scratch,
                                                        conv_splits,
                                                        pad_channels)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_plain
    from vdetr_tpu_torch.tools import time_ms

    dev = torch.device("cuda", 0)
    cfg = VDETRConfig()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    grids = cs.level_grids(cfg, dev)
    rows = []
    for li, lo, cin, cout in SHAPES:
        gi, go = grids[li], grids[lo]
        feats = (torch.randn(gi.keys.shape + (cin,), generator=gen,
                             device=dev) * gi.valid[..., None]).contiguous()
        w = torch.randn(27, cin, cout, generator=gen, device=dev)
        w = w * (2.0 / (27 * cin)) ** 0.5
        if bf16:
            feats, w = pad_channels(feats.bfloat16(), w.bfloat16())
        q = (go.coords if li == lo else go.coords * 2).contiguous()
        ref = keyed_conv_plain(feats, gi.keys, q, go.valid, gi.extent, w)
        scale = max(1.0, float(ref.abs().max()))
        B, V_in, C = feats.shape
        V = q.shape[1]
        res = {}
        for splits in SPLITS:
            out = torch.empty(B, V, cout, device=dev)
            scratch = (conv_scratch(splits, B, V, cout, bf16, dev)
                       if splits > 1 else out)

            def run():
                kernels.call(
                    "keyed_conv_bf16" if bf16 else "keyed_conv",
                    feats.data_ptr(), gi.keys.data_ptr(), q.data_ptr(),
                    go.valid.data_ptr(), w.data_ptr(), out.data_ptr(),
                    scratch.data_ptr(), B, V_in, V, C, cout, *gi.extent,
                    splits, torch.cuda.current_stream(dev).cuda_stream)

            run()
            torch.cuda.synchronize()
            err = float((out - ref).abs().max()) / scale
            res[splits] = (time_ms(run, reps=reps), err)
            del out, scratch
        label = (f"{cin}->{cout} {'submanifold' if li == lo else 'stride-2'}"
                 f" V={V} valid={int(go.valid.sum())}")
        rows.append((label, res, conv_splits(C, bf16)))
    return rows


DW_PLANS = {False: tuple((waves, min_rows) for waves in (1, 2, 4)
                        for min_rows in (128, 256, 512)),
            True: tuple((waves, min_rows) for waves in (1, 2, 3, 6)
                        for min_rows in (256, 512))}


def dw_sweep(reps: int = 20, bf16: bool = False):
    """Per shape (label, {(waves, min_rows): (splits, ms, relative
    error)}) of kernel D's f32 form, or of its bf16 form (`bf16`: bf16
    features, the stem's channels padded to 8); the error against the
    plain version relative to its max|ref|."""
    import chip_smoke as cs
    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.config import VDETRConfig
    from vdetr_tpu_torch.ops.sparse_conv_kernel import (dw_dense,
                                                        dw_row_splits,
                                                        dw_rulebook_ints,
                                                        pad_channels)
    from vdetr_tpu_torch.ops.sparse_conv_keyed import keyed_conv_dw_plain
    from vdetr_tpu_torch.tools import time_ms

    dev = torch.device("cuda", 0)
    cfg = VDETRConfig()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    grids = cs.level_grids(cfg, dev)
    rows = []
    for li, lo, cin, cout in SHAPES:
        gi, go = grids[li], grids[lo]
        feats = (torch.randn(gi.keys.shape + (cin,), generator=gen,
                             device=dev) * gi.valid[..., None]).contiguous()
        q = (go.coords if li == lo else go.coords * 2).contiguous()
        dout = (torch.randn(go.keys.shape + (cout,), generator=gen,
                            device=dev) * go.valid[..., None]).contiguous()
        if bf16:
            feats = pad_channels(feats.bfloat16())[0]
        args = (feats, gi.keys, q, go.valid, gi.extent)
        ref = keyed_conv_dw_plain(*args, dout)
        scale = float(ref.abs().max())
        B, V_in, C = feats.shape
        V = q.shape[1]
        res = {}
        for waves, min_rows in DW_PLANS[bf16]:
            splits, per = dw_row_splits(B * V, C, cout, waves, min_rows,
                                        bf16)
            dw = torch.empty(27, C, cout, device=dev)
            nbr = torch.empty(27 * B * V if dw_dense(C, bf16) else
                              dw_rulebook_ints(splits, per),
                              dtype=torch.int32, device=dev)
            scratch = (torch.empty(splits, 27, C, cout, device=dev)
                       if splits > 1 else dw)

            def run():
                kernels.call(
                    "keyed_conv_dw_bf16" if bf16 else "keyed_conv_dw",
                    feats.data_ptr(), gi.keys.data_ptr(),
                    q.data_ptr(), go.valid.data_ptr(), dout.data_ptr(),
                    dw.data_ptr(), nbr.data_ptr(), scratch.data_ptr(), B,
                    V_in, V, C, cout, *gi.extent, splits, per,
                    torch.cuda.current_stream(dev).cuda_stream)

            run()
            torch.cuda.synchronize()
            err = float((dw - ref).abs().max()) / scale
            res[(waves, min_rows)] = (splits, time_ms(run, reps=reps), err)
            del dw, nbr, scratch
        label = (f"{cin}->{cout} {'submanifold' if li == lo else 'stride-2'}"
                 f" V={V} valid={int(go.valid.sum())}")
        rows.append((label, res))
    return rows


SWEEPS = ("conv", "conv_bf16", "dw", "dw_bf16")


def main(argv=None) -> int:
    import sys

    from vdetr_tpu_torch import kernels
    from vdetr_tpu_torch.tools import card

    argv = sys.argv[1:] if argv is None else argv
    only = SWEEPS
    if argv[:1] == ["--only"] and len(argv) > 1:
        only = tuple(argv[1].split(","))
    if not set(only) <= set(SWEEPS):
        print(f"conv_splits: --only takes {','.join(SWEEPS)}")
        return 2
    if not torch.cuda.is_available():
        print("conv_splits: needs a CUDA card")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    kernels.build_all()
    for form in ("conv", "conv_bf16"):
        if form not in only:
            continue
        print(f"kernel A{' bf16' if form == 'conv_bf16' else ''} ms per "
              "launch by offset split (relative error); * the split "
              f"conv_splits picks; card {card()}")
        for label, res, chosen in sweep(bf16=form == "conv_bf16"):
            print(f"  {label}: " + "; ".join(
                f"{'*' if s == chosen else ''}{s}: {ms:.4f} ({err:.1e})"
                for s, (ms, err) in res.items()))
    from vdetr_tpu_torch.ops.sparse_conv_kernel import DW_PLAN

    for form in ("dw", "dw_bf16"):
        if form not in only:
            continue
        bf16 = form == "dw_bf16"
        print(f"kernel D{' bf16' if bf16 else ''} ms per launch by row-split "
              "plan (rounds of resident blocks, min rows a split): splits, "
              "ms (relative error); * the default plan of dw_row_splits; "
              f"card {card()}")
        for label, res in dw_sweep(bf16=bf16):
            print(f"  {label}: " + "; ".join(
                f"{'*' if plan == DW_PLAN[bf16] else ''}{plan[0]}x/"
                f"{plan[1]}: {s} {ms:.4f} ({err:.1e})"
                for plan, (s, ms, err) in res.items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
