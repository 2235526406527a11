"""The flagship forward step and the multi-device dry run: the port of the
repository's `__graft_entry__.py`.

- `entry()`: one rollout of the discovered EQ_4 model, shared by every
  patient, through the rollout kernel.
- `dryrun_multichip(n)`: every step of the pipeline over an n-shard batch
  mesh (`parallel.batch_mesh`): sharded discovery, the sharded INSITE
  fine-tune and rollout, a data-parallel CT training step, a seed-sharded
  sindy column and seed-sharded CT and G-Net columns.

    from insite_tpu_torch.entry import dryrun_multichip, entry
    fn, args = entry()              # on cuda:0; entry('cpu') on the host
    preds = fn(*args)               # [64, 59]
    dryrun_multichip(2)             # the visible cards, in turn, 2 shards
"""

from __future__ import annotations

from time import perf_counter

import numpy as np
import torch

from insite_tpu_torch.discovery.library import PolynomialLibrary
from insite_tpu_torch.ops.rollout import batched_rollout

DT = 1.0 / 6.0


def _flagship_pieces():
    """The flagship model and batch as numpy: (library, coefs [2, 7], prev
    [64, 59], statics [64, 2], arms [64, 59] int32), from seed 0."""
    lib = PolynomialLibrary(n_inputs=3)        # [y, c0, c1], the EQ_4 family
    rng = np.random.RandomState(0)
    B, T = 64, 59
    coefs = np.stack([[0, 0.3, 0, 0, -1.0, 0, 0],
                      [0, -0.2, 0, 0, 0, -1.0, 0]])
    prev = np.abs(rng.randn(B, T)) * 10 + 1
    statics = rng.rand(B, 2) * 0.4 + 0.3
    arms = rng.randint(0, 2, (B, 1)) * np.ones((B, T), np.int32)
    return lib, coefs, prev, statics, arms


def entry(device=None):
    """(fn, example_args): ``fn(coefs [A, F], y0 [B], statics [B, 2], arms
    [B, T])`` rolls every patient out under the one shared model, [B, T]
    predictions, in float32 on ``device`` (``cuda:0`` unless the caller
    asks for another). The model and batch are the JAX package's (seed 0,
    B = 64 patients, T = 59 steps, A = 2 arms, F = 7 features). On a CUDA
    device a call launches the rollout kernel once; on the CPU it runs the
    kernel's plain version."""
    device = torch.device('cuda', 0) if device is None else \
        torch.device(device)
    lib, coefs, prev, statics, arms = _flagship_pieces()

    def on(a, dtype=torch.float32):
        return torch.as_tensor(a, device=device).to(dtype)

    def fn(coefs, y0, statics, arms):
        return batched_rollout(lib, coefs[None], y0, statics, arms, DT)

    return fn, (on(coefs), on(prev[:, 0]), on(statics),
                on(arms, torch.int32))


def _ct_step(nets: list, cfg, params: list, shards: list, lead):
    """One data-parallel CT training step, as the JAX dry run takes it
    (alpha 0.01, the balancing of the config, SGD at 1e-3), without
    dropout: ``nets`` and ``params`` hold the network and one replica of
    its parameters a shard, on the shard's device. Each shard's masked
    loss sums and counts are combined into the whole batch's means, so the
    loss and the summed gradient are the unsharded step's. Returns (loss,
    the updated parameters on ``lead``)."""
    from torch.func import functional_call

    from insite_tpu_torch.models.nn.training import br_loss_elements
    alpha = 0.01
    terms = []
    for net, p, batch in zip(nets, params, shards):
        tp, op, _ = functional_call(net, p, (batch, alpha))
        mse, active, bce_elem, active_t = br_loss_elements(
            tp, op, batch, alpha, cfg.balancing, cfg.treatment_mode)
        terms.append(((mse * active).sum(), active.sum(),
                      (bce_elem * active_t).sum(), active_t.sum()))
    counts = [sum(t[i].to(lead) for t in terms).clamp(min=1.0)
              for i in (1, 3)]
    loss, grads = 0.0, None
    for p, t in zip(params, terms):
        dev = t[0].device
        part = t[0] / counts[0].to(dev) + t[2] / counts[1].to(dev)
        g = torch.autograd.grad(part, list(p.values()), allow_unused=True,
                                materialize_grads=True)
        g = [x.to(lead) for x in g]
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        loss = loss + part.detach().to(lead)
    updated = {k: v.detach().to(lead) - 1e-3 * g
               for (k, v), g in zip(params[0].items(), grads)}
    return loss, updated


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """Every step of the JAX package's dry run over a mesh of ``n_devices``
    shards: ``devices`` (the visible CUDA cards unless given) repeated in
    turn, so that one card can hold several shards. In order:

    1. STLSQ on sharded rows (8 or 2n patients, 11 steps of the flagship
       batch): each shard's QR on its device, the reductions stacked and
       reduced again (TSQR), the padding weighed 0 by the row mask;
    2. the INSITE fine-tune (BFGS, 8 iterations, one sensitivity launch a
       shard and evaluation) and rollout, sharded by rows;
    3. one data-parallel CT training step: a replica of the parameters a
       shard, the batch (2n rows) sharded, the loss as sums and counts,
       the gradients summed onto the first device and the update sent
       back to every replica; held against the same step unsharded;
    4. a seed-sharded sindy column of `vectorized_eq4_sweep` (n seeds);
    5. seed-sharded CT and G-Net columns (n seeds, 1 epoch);
    6. the sensitivity kernel shard by shard against one unsharded call.

    Everything runs in float32. Asserts that every result is finite and
    has its shape; returns each step's result and wall time."""
    from insite_tpu_torch.discovery.stlsq import stlsq_hostsolve
    from insite_tpu_torch.harness.vectorized import vectorized_eq4_sweep
    from insite_tpu_torch.harness.vectorized_neural import (
        vectorized_ct_sweep, vectorized_gnet_sweep)
    from insite_tpu_torch.models.ct import CTConfig, CTNetwork
    from insite_tpu_torch.models.nn.training import bases_on, seeded_net
    from insite_tpu_torch.models.sindy import (insite_finetune_predict,
                                               support)
    from insite_tpu_torch.ops.rollout import rollout_with_sens
    from insite_tpu_torch.parallel import (batch_mesh, gather_rows, row_mask,
                                           shard_rows)

    devices = list(batch_mesh(devices))
    mesh = batch_mesh([devices[i % len(devices)] for i in range(n_devices)])
    lead = mesh[0]
    f32 = torch.float32
    walls, out = {}, {}
    lib, coefs, prev, statics, arms = _flagship_pieces()
    B, T = max(2 * n_devices, 8), 11
    prev, statics, arms = prev[:B, :T], statics[:B], arms[:B, :T]
    lengths = np.full(B, T)
    rows = (torch.tensor(prev, dtype=f32), torch.tensor(statics, dtype=f32),
            torch.tensor(arms, dtype=torch.int32), torch.tensor(lengths))
    shards, n = shard_rows(rows, mesh)

    # 1. sharded discovery: the rows' features and targets on their
    # devices, one QR a shard, TSQR across them
    t0 = perf_counter()
    thetas, ys = [], []
    for p, s, _, _ in shards:
        X = torch.cat([p[..., None], s[:, None, :].expand(*p.shape, 2)], -1)
        thetas.append(lib(X).reshape(-1, lib.n_features))
        ys.append(torch.gradient(p, dim=1)[0].reshape(-1))
    weights = [m.repeat_interleave(T) for m in row_mask(n, mesh)]
    c_global, _ = stlsq_hostsolve(thetas, ys, 0.05, 0.5,
                                  sample_weight=weights)
    assert c_global.shape == (lib.n_features,)
    assert np.isfinite(c_global).all()
    walls['stlsq'], out['stlsq_coefs'] = perf_counter() - t0, c_global

    # 2. the sharded INSITE fine-tune and rollout
    t0 = perf_counter()
    active = support(coefs)
    parts = [insite_finetune_predict(
        lib, torch.tensor(coefs, dtype=f32, device=p.device), p, s, a, ln,
        DT, 10.0, projection_horizon=1, bfgs_maxiter=8,
        active_idx=active)[:2] for p, s, a, ln in shards]
    preds, fitted = gather_rows(parts, n)
    assert preds.shape == (B, T) and fitted.shape == (B, 2, 7)
    assert torch.isfinite(preds).all() and torch.isfinite(fitted).all()
    walls['finetune'], out['finetune_preds'] = perf_counter() - t0, preds

    # 3. one data-parallel CT training step
    t0 = perf_counter()
    ct_cfg = CTConfig(dim_treatments=2, dim_static_features=2,
                      dim_outcome=1, seq_hidden_units=8, br_size=4,
                      fc_hidden_units=8, num_heads=2)
    net = seeded_net(0, lambda: CTNetwork(ct_cfg), lead)
    B2, T2 = 2 * n_devices, 10
    r = np.random.RandomState(0)
    batch = {
        'prev_treatments': r.rand(B2, T2, 2),
        'prev_outputs': r.rand(B2, T2, 1),
        'static_features': r.rand(B2, 2),
        'current_treatments': (r.rand(B2, T2, 2) > 0.5) * 1.0,
        'outputs': r.rand(B2, T2, 1),
        'active_entries': np.ones((B2, T2, 1)),
    }
    batch = {k: torch.tensor(v, dtype=f32) for k, v in batch.items()}
    params = {k: v.detach() for k, v in net.named_parameters()}
    batch_shards, _ = shard_rows(batch, mesh)
    replicas = [{k: v.to(d).requires_grad_() for k, v in params.items()}
                for d in mesh]
    loss, updated = _ct_step(bases_on(net, mesh), ct_cfg, replicas,
                             batch_shards, lead)
    replicas = [{k: v.to(d) for k, v in updated.items()} for d in mesh]
    whole = {k: v.to(lead) for k, v in batch.items()}
    loss_1, updated_1 = _ct_step(
        [net], ct_cfg,
        [{k: v.to(lead).requires_grad_() for k, v in params.items()}],
        [whole], lead)
    assert torch.isfinite(loss)
    torch.testing.assert_close(loss, loss_1, rtol=1e-5, atol=1e-7)
    for k in updated:
        torch.testing.assert_close(updated[k], updated_1[k], rtol=1e-5,
                                   atol=1e-7)
    assert all(torch.equal(rep[k].to(lead), updated[k])
               for rep in replicas for k in updated)
    walls['ct_step'], out['ct_loss'] = perf_counter() - t0, float(loss)

    # 4. the seed-sharded sindy column
    t0 = perf_counter()
    sweep = vectorized_eq4_sweep('EQ_4_D', n_seeds=n_devices, n_train=16,
                                 n_test=4, seq_length=12, method='sindy',
                                 mesh=mesh)
    assert sweep['encoder_test_rmse_orig'].shape == (n_devices,)
    assert np.isfinite(sweep['encoder_test_rmse_orig']).all()
    walls['sindy_column'], out['sindy_column'] = perf_counter() - t0, sweep

    # 5. the seed-sharded CT and G-Net columns
    tiny = {'train': 16, 'val': 4, 'test': 4}
    t0 = perf_counter()
    ct_col = vectorized_ct_sweep('EQ_4_D', n_seeds=n_devices,
                                 num_patients=tiny, epochs=1, eval_chunk=16,
                                 max_seq_length=12, mesh=mesh)
    assert np.isfinite(ct_col['encoder_test_rmse_orig']).all()
    walls['ct_column'], out['ct_column'] = perf_counter() - t0, ct_col
    t0 = perf_counter()
    gnet_col = vectorized_gnet_sweep('EQ_4_D', n_seeds=n_devices,
                                     num_patients=tiny, epochs=1,
                                     eval_chunk=16, mc_samples=2,
                                     max_seq_length=12, mesh=mesh)
    assert gnet_col['decoder_test_rmse_6-step'].shape == (n_devices,)
    assert np.isfinite(gnet_col['decoder_test_rmse_6-step']).all()
    walls['gnet_column'], out['gnet_column'] = perf_counter() - t0, gnet_col

    # 6. the sensitivity kernel (its plain version on CPU shards) shard by
    # shard, against one call over the unsharded rows
    t0 = perf_counter()
    per_row = np.broadcast_to(coefs, (B,) + coefs.shape)
    args, _ = shard_rows((torch.tensor(per_row, dtype=f32),) + rows[:3],
                         mesh)
    y_s, s_s = gather_rows([rollout_with_sens(lib, c, p[:, 0], s, a, DT,
                                              active)
                            for c, p, s, a in args], n)
    y_1, s_1 = rollout_with_sens(
        lib, torch.tensor(per_row, dtype=f32, device=lead),
        rows[0][:, 0].to(lead), rows[1].to(lead), rows[2].to(lead), DT,
        active)
    torch.testing.assert_close(y_s, y_1, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(s_s, s_1, rtol=1e-6, atol=0.0)
    walls['sens_kernel'] = perf_counter() - t0

    print(f'[dryrun_multichip] ok: {n_devices} shards on '
          f'{len(set(mesh))} device(s), {preds.shape[0]} sharded rows, '
          f'coefs={np.round(c_global, 4)}, dp CT train-step loss='
          f'{float(loss):.4f}, sharded {n_devices}-seed sweep rmse='
          f'{np.round(sweep["encoder_test_rmse_orig"], 4)}, sharded CT '
          f'column rmse={np.round(ct_col["encoder_test_rmse_orig"], 3)}, '
          f'sharded G-Net column 6-step='
          f'{np.round(gnet_col["decoder_test_rmse_6-step"], 3)}, '
          f'sensitivities {tuple(s_s.shape)} shard by shard == unsharded',
          flush=True)
    out['walls'] = walls
    return out
