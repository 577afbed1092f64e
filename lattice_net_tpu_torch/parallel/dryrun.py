"""A parallel dry run on small shapes (the port's counterpart of the JAX
package's ``dryrun_multichip``):

    python -m lattice_net_tpu_torch.parallel.dryrun [--ranks N] [--device cpu] [--backend gloo]

Over N spawned ranks (default: one a visible card over NCCL; ``--device
cpu`` needs ``--ranks``, over gloo) it runs

1. two data-parallel steps over an N-cloud batch of toy clouds, held
   against two single-device steps over the whole batch (loss to 2e-5
   relative, parameters to 1e-5), every rank's parameters bit-equal after;
2. the lattice-sharded U-Net forward and one sharded train step on a
   corridor cloud striped over the N ranks, without overflow;
3. with N even and at least 4, one hybrid step over a (N/4, 4) mesh, or
   (N/2, 2) where 4 does not divide N, on a batch of corridor clouds;

and prints one line for each, as the JAX dry run does.  Convs run in f32.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from lattice_net_tpu_torch.data.toy import make_toy_cloud
from lattice_net_tpu_torch.models.lnn import LNN, ModelParams, prepare_cloud
from lattice_net_tpu_torch.parallel import data_parallel as dp
from lattice_net_tpu_torch.parallel import lattice_sharded as ls
from lattice_net_tpu_torch.parallel.mesh import BACKENDS, Mesh, check_replicated, launch, plan_ranks
from lattice_net_tpu_torch.train.optim import make_optimizer

MODEL = ModelParams(
    nr_classes=4, pointnet_channels_per_layer=(8, 8), pointnet_start_nr_channels=8, nr_downsamples=2,
    nr_blocks_down_stage=(1, 1), nr_blocks_bottleneck=1, nr_blocks_up_stage=(1, 1),
)  # fmt: skip
SIGMA, CAPS, N_POINTS = 0.25, (256, 128, 64), 128
SP_SIGMA, SP_CAPS = 0.5, (4096, 2048, 512)


def _corridor(rng, n: int, half: float):
    p = np.stack([rng.uniform(-half, half, n), rng.uniform(-1, 1, n), rng.uniform(-1, 1, n)], 1).astype(np.float32)
    return p, np.zeros((n, 1), np.float32), (p[:, 0] > 0).astype(np.int32) + 1


def _rank(device, n: int) -> list:
    lines = []
    model = LNN(MODEL, torch.Generator().manual_seed(0), device=device, conv_dtype=torch.float32)
    params = dict(model.state_dict())

    # 1. data parallelism against one device over the whole batch
    mesh = Mesh(("dp",), (n,))
    clouds = [prepare_cloud(make_toy_cloud(100 + 5 * i, 4, seed=i), MODEL) for i in range(n)]
    host = dp.make_host_batch(clouds, N_POINTS, rng=np.random.default_rng(0))
    tx = make_optimizer(1e-3, weight_decay=1e-4, schedule="cosine_warm_restarts", t0_steps=100)
    state0 = dp.TrainState.create(params, tx)
    state = dp.replicate_state(state0)
    step = dp.make_dp_train_step(model, tx, mesh, SIGMA, MODEL.nr_downsamples, CAPS)
    batch = dp.shard_batch(host, mesh, "dp", device)
    gen = dp.rank_generator(0, mesh.rank, device)
    for _ in range(2):
        state, metrics = step(state, batch, gen)
    single = dp.make_train_step(model, tx, SIGMA, MODEL.nr_downsamples, CAPS)
    s_state, whole = state0, dp.to_device(host, device)
    for _ in range(2):
        s_state, s_metrics = single(s_state, whole)
    loss = float(metrics["loss"])
    if not np.isfinite(loss) or state.step != 2:
        raise RuntimeError(f"DP steps: loss {loss}, step {state.step}")
    np.testing.assert_allclose(loss, float(s_metrics["loss"]), rtol=2e-5)
    for k, p in state.params.items():
        np.testing.assert_allclose(p.cpu().numpy(), s_state.params[k].cpu().numpy(), rtol=0, atol=1e-5, err_msg=k)
    check_replicated(state.params)
    lines.append(f"dryrun({n}): 2 DP steps, loss={loss:.4f} acc={float(metrics['acc']):.3f}; "
                 "params match single-device to 1e-5")  # fmt: skip

    # 2. the sharded U-Net: forward and one train step on a striped corridor
    rng = np.random.default_rng(3)
    pos, vals, tgts = _corridor(rng, 256 * n, 40.0 * n)
    pos_s, val_s, mask_s, ids_s, bounds = ls.shard_points_host(pos, vals, SP_SIGMA, n)
    tgt_s = np.where(ids_s >= 0, tgts[np.clip(ids_s, 0, None)], 0)
    sp_mesh = Mesh(("sp",), (n,))
    fwd = ls.make_sharded_lnn_forward(sp_mesh, model, SP_SIGMA, MODEL.nr_downsamples, SP_CAPS, pos_s.shape[1])
    logp, nv, ov = fwd(params, pos_s, val_s, mask_s, bounds)
    if not bool(torch.isfinite(logp).all()) or int(ov) != 0:
        raise RuntimeError(f"sharded forward: finite {bool(torch.isfinite(logp).all())}, overflow {int(ov)}")
    verts = sp_mesh.all_gather(nv.reshape(1).to(torch.int64), "sp").reshape(-1).tolist()
    sp_tx = make_optimizer(1e-3)
    sp_step = ls.make_sharded_lnn_train_step(
        sp_mesh, model, sp_tx, SP_SIGMA, MODEL.nr_downsamples, SP_CAPS, pos_s.shape[1], ignore_index=0
    )
    _, sp_metrics = sp_step(dp.TrainState.create(params, sp_tx), pos_s, val_s, tgt_s, mask_s, bounds)
    sp_loss = float(sp_metrics["loss"])
    if not np.isfinite(sp_loss) or int(sp_metrics["overflow"]) != 0:
        raise RuntimeError(f"sharded step: loss {sp_loss}, overflow {int(sp_metrics['overflow'])}")
    lines.append(f"dryrun({n}): sharded U-Net fwd + train step ok, loss={sp_loss:.4f}, verts/shard={verts}")

    # 3. hybrid dp x sp
    if n % 2 == 0 and n >= 4:
        n_sp = 4 if n % 4 == 0 and n >= 8 else 2
        n_dp = n // n_sp
        clouds = [_corridor(rng, 1024, 60.0) for _ in range(n_dp)]
        pos_b, val_b, tgt_b, mask_b, _, bounds_b = ls.shard_clouds_host(clouds, SP_SIGMA, n_sp, ignore_index=0)
        mesh2 = Mesh(("dp", "sp"), (n_dp, n_sp))
        hy_step = ls.make_hybrid_lnn_train_step(
            mesh2, model, sp_tx, SP_SIGMA, MODEL.nr_downsamples, SP_CAPS, pos_b.shape[2], ignore_index=0
        )
        _, hy_metrics = hy_step(dp.TrainState.create(params, sp_tx), pos_b, val_b, tgt_b, mask_b, bounds_b)
        hy_loss = float(hy_metrics["loss"])
        if not np.isfinite(hy_loss) or int(hy_metrics["overflow"]) != 0:
            raise RuntimeError(f"hybrid step: loss {hy_loss}, overflow {int(hy_metrics['overflow'])}")
        lines.append(f"dryrun({n}): hybrid dp{n_dp} x sp{n_sp} train step ok, loss={hy_loss:.4f}")
    return lines


def dryrun(ranks: int | None = None, device=None, backend: str | None = None) -> list:
    """Run the three checks over the ranks; prints and returns rank 0's lines."""
    plan = plan_ranks(ranks, device, backend)
    lines = launch(_rank, plan.count, ranks=plan)[0]
    for line in lines:
        print(line)
    return lines


def main():
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ranks", type=int, default=None, help="rank count (default: one a visible card)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--backend", choices=BACKENDS, default=None, help="default nccl on the card, gloo on the CPU")
    args = ap.parse_args()
    dryrun(args.ranks, args.device, args.backend)


if __name__ == "__main__":
    main()
