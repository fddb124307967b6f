"""Export a trained model as one self-contained `torch.export` program
(counterpart of the JAX package's `scripts/export_model.py`): the weights
inside, fixed input shapes, the port's forward kernels held as the custom
ops of `kernels/ops.py`, so no model code is needed to serve it.

    python -m dpcr_agb_tpu_torch.export_model checkpoint_dir=outputs/run \\
        model_name=SENet14 output=model.pt2 [weight_name=latest] \\
        [batch_size=16] [num_points=16000] [feature_dim=3] \\
        [transform_type=sparse_xy] [device=cpu]

The checkpoint is the port's `<model_name>.pt` or, without one, the JAX
package's `<model_name>.ckpt` (`serving.load_serving_bundle`). The program
takes plain tensors
    (pos [B,N,3] f32, x [B,N,C] f32, mask [B,N] bool, coords [B,N,3] i32)
(PAD_COORD = -2^20 padding) and returns de-standardized predictions
[B, n_targets] f32. `num_points` defaults to the collate spec's fixed
count, else its largest bucket, else 16000; `feature_dim` to 3. A sidecar
`<output>.json` records the shapes, the target names, the transform
preset the inputs must have gone through (the host pipeline is not part
of the program), the platform, and the port's own keys: `modes` (the
sparse-voxel nets' level-0 and pool modes, read from the environment
when the net was built and baked into the program), `dtype` and
`numerics`.

It runs on CUDA unless `device=cpu` is given, and raises when there is no
CUDA device and the CPU was not asked for. KPConv (its neighbour pyramids
are inputs the host builds per batch) and map mode (`dense_dims=null`, its
kernel maps likewise) raise.

`load(path, device=None)` reads a program back with torch and the op
registrations only (nothing of the model code), pins the float32
precision as the entry points do, and returns its module."""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import List, Optional

import torch

from .device import numerics, pin_numerics
from .kernels import ops as _registrations  # noqa: F401  (dpcr_port ops)

log = logging.getLogger(__name__)

PAD_COORD = -(2 ** 20)
INPUTS = ("pos[B,N,3]f32, x[B,N,C]f32, mask[B,N]bool, "
          "coords[B,N,3]i32 (PAD_COORD=-2^20 padding)")


def _parse(overrides: List[str]) -> dict:
    args = {}
    for o in overrides:
        if "=" not in o:
            raise ValueError(f"expected key=value, got {o!r}")
        k, v = o.split("=", 1)
        args[k] = v
    for req in ("checkpoint_dir", "model_name", "output"):
        if req not in args:
            raise ValueError(f"export_model requires {req}=")
    return args


def _modes(net) -> Optional[dict]:
    names = ("l0_mode", "stem_mode", "pool_bwd", "sparse_pool", "pool_fwd")
    if not all(hasattr(net, n) for n in names):
        return None
    return {**{n: getattr(net, n) for n in names},
            "sparse_level0": bool(net.sparse_level0)}


def main(overrides=None) -> str:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s: %(message)s")
    args = _parse(list(overrides if overrides is not None
                       else sys.argv[1:]))
    from .models.factory import export_aux
    from .serving import ExportModule, load_serving_bundle

    t0 = time.perf_counter()
    b = load_serving_bundle(args["checkpoint_dir"], args["model_name"],
                            args.get("weight_name", "latest"),
                            device=args.get("device"),
                            transform_type=args.get("transform_type"))
    aux = export_aux(b.net)
    bs = int(args.get("batch_size", 16))
    n_pts = int(args.get("num_points")
                or b.collate_spec.num_points
                or (max(b.collate_spec.buckets)
                    if b.collate_spec.buckets else 16000))
    # the NFI presets build x = [ones, pos_z, xy_distance]
    c_dim = int(args.get("feature_dim", 0)) or 3
    dev = b.device
    ex_args = (torch.zeros((bs, n_pts, 3), dtype=torch.float32, device=dev),
               torch.zeros((bs, n_pts, c_dim), dtype=torch.float32,
                           device=dev),
               torch.zeros((bs, n_pts), dtype=torch.bool, device=dev),
               torch.full((bs, n_pts, 3), PAD_COORD, dtype=torch.int32,
                          device=dev))
    module = ExportModule(b, aux).eval()
    with torch.no_grad():
        program = torch.export.export(module, ex_args)
    torch.export.save(program, args["output"])
    dtype = getattr(b.net, "dtype", torch.float32)   # f32-only nets lack it
    sidecar = {
        "model_name": args["model_name"],
        "weight_name": args.get("weight_name", "latest"),
        "batch_size": bs, "num_points": n_pts, "feature_dim": c_dim,
        "use_coords": bool(b.collate_spec.use_coords),
        "reg_targets": b.reg_targets,
        "transform_type": args.get("transform_type")
        or b.data_cfg["transform_type"],
        "inputs": INPUTS,
        "platforms": [dev.type],
        "modes": _modes(b.net),
        "dtype": str(dtype).replace("torch.", ""),
        "numerics": numerics(),
    }
    with open(args["output"] + ".json", "w") as f:
        json.dump(sidecar, f, indent=1)
    log.info(f"exported {os.path.getsize(args['output']) / 1e6:.1f} MB "
             f"torch.export program to {args['output']} (platform "
             f"{dev.type}, {time.perf_counter() - t0:.1f} s)")
    return args["output"]


def load(path: str, device=None) -> torch.nn.Module:
    """The program at `path` as a module on `device` (by default the
    device it was exported on; another one moves its weights and
    constants there), its weights frozen. Pins the float32 precision as
    the entry points do (`device.pin_numerics`: TF32 off, which PyTorch's
    default leaves on in cuDNN's convolutions). Needs torch and the op
    registrations only."""
    pin_numerics()
    program = torch.export.load(path)
    if device is not None:
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        from torch.export.passes import move_to_device_pass
        program = move_to_device_pass(program, device)
    module = program.module()
    for p in module.parameters():
        p.requires_grad_(False)
    return module


if __name__ == "__main__":
    main()
