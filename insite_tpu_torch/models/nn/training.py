"""The training loops of the neural baselines, in the meaning of
`insite_tpu.models.nn.training`: the two-optimizer adversarial training of
the balanced-representation baselines (CT, CRN, EDCT; `fit_br_model`) and
the single-optimizer training of RMSN's four networks and G-Net
(`fit_simple`).

`fit_br_model`: per batch, optimizer 0 (every parameter but the treatment classifier) steps
on the masked outcome MSE plus the balancing loss; then optimizer 1 (the
classifier, `treatment_head_mask`) steps on the treatment BCE computed at
the updated parameters, with the representation detached; then, with
``weights_ema``, one exponential moving average step of every parameter.
With ``weights_ema`` the first loss sees the classifier's EMA weights and
the second the EMA weights of everything else. Alpha rises per epoch
(`alpha_at_epoch`); batches are reshuffled every epoch and dropped at the
end (`make_batches`).

`fit_simple`: one optimizer over every parameter, one step a batch on a
loss the caller gives, no EMA.

`fit_br_column` and `fit_simple_column` are the two for a column of S
seeds at once (the vectorized columns): the S networks' parameters stacked
on a leading seed axis (`stack_nets`), each batch one `torch.func.vmap`
forward over them and one gradient of the sum of the S per-seed losses,
the optimizers stepping every seed and clipping each seed by its own norm.

Both loops run on the device of the data: the batch indices and every
dropout mask come from one `torch.Generator` on that device, and nothing in
them copies to the host.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
from torch.func import functional_call

from insite_tpu_torch.models.base import CausalEstimator
from insite_tpu_torch.models.nn.blocks import bce, first_attention_maps


@dataclass
class TrainConfig:
    epochs: int = 100
    batch_size: int = 64
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    optimizer: str = 'adam'
    momentum: float = 0.9
    max_grad_norm: Optional[float] = None
    balancing: str = 'grad_reverse'     # grad_reverse / domain_confusion
    alpha: float = 0.0
    update_alpha: bool = True
    alpha_rate: str = 'exp'
    weights_ema: bool = False
    beta: float = 0.99                  # EMA decay
    treatment_mode: str = 'multiclass'


def encoder_decoder_train_configs(cfg) -> tuple:
    """The encoder's and the decoder's `TrainConfig` of a two-stage model
    config (CRN, EDCT): the stage's batch size and learning rate, the
    balancing, alpha, EMA and treatment mode shared."""
    common = dict(epochs=cfg.epochs, balancing=cfg.balancing,
                  alpha=cfg.alpha, update_alpha=cfg.update_alpha,
                  weights_ema=cfg.weights_ema, beta=cfg.beta,
                  treatment_mode=cfg.treatment_mode)
    return (TrainConfig(batch_size=cfg.enc_batch_size,
                        learning_rate=cfg.enc_learning_rate, **common),
            TrainConfig(batch_size=cfg.dec_batch_size,
                        learning_rate=cfg.dec_learning_rate, **common))


def _base_optimizer(params, cfg: TrainConfig):
    """Adam, AdamW (decoupled weight decay) or SGD with momentum over
    ``params``, at ``cfg.learning_rate``; ``cfg.max_grad_norm`` clips in
    `_step`."""
    if cfg.optimizer == 'adam':
        return torch.optim.Adam(params, lr=cfg.learning_rate)
    if cfg.optimizer == 'adamw':
        return torch.optim.AdamW(params, lr=cfg.learning_rate,
                                 weight_decay=cfg.weight_decay)
    if cfg.optimizer == 'sgd':
        return torch.optim.SGD(params, lr=cfg.learning_rate,
                               momentum=cfg.momentum)
    raise NotImplementedError(cfg.optimizer)


def _step(opt, params, grads, max_grad_norm=None):
    """One step of ``opt`` with ``grads``, first scaled to a global norm of
    at most ``max_grad_norm`` (over these parameters) when it is set."""
    if max_grad_norm:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        grads = [torch.where(norm < max_grad_norm, g,
                             g / norm * max_grad_norm) for g in grads]
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def alpha_at_epoch(epoch, max_epochs, alpha_max, rate='exp',
                   update_alpha=True):
    """The balancing weight of epoch ``epoch`` (a float32 tensor): epoch e
    trains with f(e / max_epochs) * alpha_max, so epoch 0 at 0. Computed in
    float32, as the JAX package's loop does."""
    if not update_alpha:
        return torch.as_tensor(alpha_max, dtype=torch.float32)
    p = torch.as_tensor(epoch, dtype=torch.float32) / max_epochs
    if rate == 'lin':
        return p * alpha_max
    return (2.0 / (1.0 + torch.exp(-10.0 * p)) - 1.0) * alpha_max


@torch.no_grad()
def _ema_update(ema: list, params: list, count: int, decay: float) -> int:
    """EMA step in place with the warm-up decay d = min(decay,
    (1 + n) / (10 + n)): e <- e * d + (1 - d) * p. Returns n + 1."""
    d = min(decay, (1.0 + count) / (10.0 + count))
    torch._foreach_mul_(ema, d)
    torch._foreach_add_(ema, params, alpha=1.0 - d)
    return count + 1


def merge_by_mask(a: dict, b: dict, mask: dict) -> dict:
    """Take ``a[name]`` where ``mask[name]``, else ``b[name]``."""
    return {name: a[name] if m else b[name] for name, m in mask.items()}


def masked_mean(x, active):
    """Mean of ``x`` over the active entries; 0 for a batch without any."""
    return (x * active).sum() / active.sum().clamp(min=1.0)


def br_losses(treatment_pred, outcome_pred, batch, alpha, balancing,
              treatment_mode):
    """Optimizer 0's loss terms: the masked outcome MSE and the balancing
    BCE (against the factual treatments, or, for domain confusion, alpha
    times the BCE against uniform targets)."""
    mse, active, bce_elem, active_t = br_loss_elements(
        treatment_pred, outcome_pred, batch, alpha, balancing,
        treatment_mode)
    return masked_mean(mse, active), masked_mean(bce_elem, active_t)


def br_loss_elements(treatment_pred, outcome_pred, batch, alpha, balancing,
                     treatment_mode):
    """The elements `br_losses` averages, each with its mask: (squared
    outcome error, active entries, balancing BCE, active steps). A batch
    split over devices sums them and their masks per shard."""
    mse = (outcome_pred - batch['outputs']) ** 2
    active = batch['active_entries']
    if balancing == 'grad_reverse':
        bce_elem = bce(treatment_pred, batch['current_treatments'],
                       treatment_mode)
    else:
        uniform = torch.ones_like(batch['current_treatments'])
        if treatment_mode == 'multiclass':
            uniform = uniform / uniform.shape[-1]
        else:
            uniform = uniform * 0.5
        bce_elem = alpha * bce(treatment_pred, uniform, treatment_mode)
    return mse, active, bce_elem, active[..., 0]


def make_batches(gen, n: int, batch_size: int):
    """A shuffled drop-last index matrix ``[n // batch_size, batch_size]``
    on the generator's device."""
    perm = torch.randperm(n, generator=gen, device=gen.device)
    n_batches = n // batch_size
    return perm[:n_batches * batch_size].view(n_batches, batch_size)


def treatment_head_mask(net: torch.nn.Module) -> dict:
    """{parameter name: whether it belongs to the adversarial treatment
    classifier}: linear2 and linear3 of ``br_treatment_outcome_head``."""
    def treat(path):
        return 'br_treatment_outcome_head' in path and \
            ('linear2' in path or 'linear3' in path)
    return {name: treat(name.split('.'))
            for name, _ in net.named_parameters()}


def fit_br_model(net: torch.nn.Module, data: dict, cfg: TrainConfig,
                 gen: torch.Generator, augment_fn=None) -> dict:
    """Train ``net``'s parameters in place on ``data`` (tensors with a
    leading row dimension, on the generator's device) and return the EMA of
    every parameter, {name: tensor}, which without ``weights_ema`` stays at
    the initial parameters. ``net(batch, alpha, gen=, detach_treatment=)``
    returns (treatment logits, outcome prediction, representation). With
    ``augment_fn``, each batch becomes ``augment_fn(batch, gen)`` before
    the step, and both optimizers' losses see that one batch (CT's
    masked-vitals augmentation)."""
    params = dict(net.named_parameters())
    treat = treatment_head_mask(net)
    group0 = [p for k, p in params.items() if not treat[k]]
    group1 = [p for k, p in params.items() if treat[k]]
    opt0 = _base_optimizer(group0, cfg)
    opt1 = _base_optimizer(group1, cfg)
    ema = {k: p.detach().clone() for k, p in params.items()}
    ema_list, param_list = list(ema.values()), list(params.values())

    def forward(p, batch, alpha, detach_treatment):
        return functional_call(net, p, (batch, alpha),
                               {'gen': gen,
                                'detach_treatment': detach_treatment})

    def grads(loss, group):
        return torch.autograd.grad(loss, group, allow_unused=True,
                                   materialize_grads=True)

    n = next(iter(data.values())).shape[0]
    bs = min(cfg.batch_size, n)
    alphas = alpha_at_epoch(torch.arange(cfg.epochs), cfg.epochs, cfg.alpha,
                            cfg.alpha_rate, cfg.update_alpha)
    alphas = alphas.expand(cfg.epochs).to(gen.device)
    count = 0
    for epoch in range(cfg.epochs):
        alpha = alphas[epoch]
        for idx in make_batches(gen, n, bs):
            batch = {k: v[idx] for k, v in data.items()}
            if augment_fn is not None:
                batch = augment_fn(batch, gen)

            p = merge_by_mask(ema, params, treat) if cfg.weights_ema \
                else params
            tp, op, _ = forward(p, batch, alpha, False)
            mse_loss, bce_loss = br_losses(tp, op, batch, alpha,
                                           cfg.balancing, cfg.treatment_mode)
            _step(opt0, group0, grads(mse_loss + bce_loss, group0),
                  cfg.max_grad_norm)

            p = merge_by_mask(params, ema, treat) if cfg.weights_ema \
                else params
            tp, _, _ = forward(p, batch, alpha, True)
            bce_elem = bce(tp, batch['current_treatments'],
                           cfg.treatment_mode)
            if cfg.balancing == 'domain_confusion':
                bce_elem = alpha * bce_elem
            loss1 = masked_mean(bce_elem, batch['active_entries'][..., 0])
            _step(opt1, group1, grads(loss1, group1), cfg.max_grad_norm)

            if cfg.weights_ema:
                count = _ema_update(ema_list, param_list, count, cfg.beta)
    for p in param_list:
        p.grad = None
    return ema


def fit_simple(net: torch.nn.Module, loss_fn, data: dict, cfg: TrainConfig,
               gen: torch.Generator) -> torch.nn.Module:
    """Train ``net``'s parameters in place on ``data`` (tensors with a
    leading row dimension, on the generator's device) with one optimizer
    (`_base_optimizer`, clipped to ``cfg.max_grad_norm``): per epoch,
    shuffled drop-last batches of ``min(cfg.batch_size, rows)`` rows, one
    step each on ``loss_fn(net, batch, gen)``, whose dropout masks come from
    ``gen``. Returns ``net``."""
    params = list(net.parameters())
    opt = _base_optimizer(params, cfg)
    n = next(iter(data.values())).shape[0]
    bs = min(cfg.batch_size, n)
    for _ in range(cfg.epochs):
        for idx in make_batches(gen, n, bs):
            batch = {k: v[idx] for k, v in data.items()}
            grads = torch.autograd.grad(loss_fn(net, batch, gen), params,
                                        allow_unused=True,
                                        materialize_grads=True)
            _step(opt, params, grads, cfg.max_grad_norm)
    for p in params:
        p.grad = None
    return net


# ---------------------------------------------------------------------------
# seed columns: S networks of one architecture trained as one


def stack_nets(nets) -> tuple:
    """``(base, params)``: ``nets[0]``, whose forward `stacked_call` and
    the column fits run with the seeds' parameters, and the parameters of
    the S ``nets`` (one architecture) stacked on a leading seed axis,
    {name: [S, ...]}, as new leaf tensors that require gradients. Buffers
    stay ``base``'s own, shared by the seeds."""
    params, _ = torch.func.stack_module_state(list(nets))
    return nets[0], params


def stacked_call(base, params: dict, args: tuple, kwargs=None):
    """``base(*args, **kwargs)`` under `torch.func.vmap` over the seed axis
    of ``params`` and of every tensor in ``args`` (no dropout: ``kwargs``
    are shared by the seeds)."""
    kwargs = kwargs or {}

    def one(p, a):
        return functional_call(base, p, a, kwargs)

    return torch.func.vmap(one)(params, args)


def column_batches(gen, n_seeds: int, n: int, batch_size: int):
    """Per seed a shuffled drop-last index matrix, stacked: ``[n //
    batch_size, n_seeds, batch_size]`` on the generator's device, so that
    every seed takes the same number of batches."""
    perms = torch.stack([torch.randperm(n, generator=gen, device=gen.device)
                         for _ in range(n_seeds)])
    n_batches = n // batch_size
    return perms[:, :n_batches * batch_size].view(
        n_seeds, n_batches, batch_size).transpose(0, 1)


def _gather_rows(data: dict, idx):
    """``data[k][s, idx[s]]`` for every seed s: [S, batch, ...]."""
    seeds = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return {k: v[seeds, idx] for k, v in data.items()}


def _step_column(opt, params, grads, max_grad_norm=None):
    """`_step` with a seed axis: each seed's gradients scaled to a global
    norm of at most ``max_grad_norm`` over its own slices, then one step
    of ``opt`` (elementwise, so each seed's update is its own)."""
    if max_grad_norm:
        norm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.flatten(1), dim=1) for g in grads]),
            dim=0)                                          # [S]
        clipped = []
        for g in grads:
            n = norm.view((-1,) + (1,) * (g.dim() - 1))
            clipped.append(torch.where(n < max_grad_norm, g,
                                       g / n * max_grad_norm))
        grads = clipped
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()


def _seed_blocks(base, params, data, gen, block_gens):
    """The blocks of a column fit: ``params`` and ``data`` as one dict
    each (the whole column, on one device) or as lists, one seed block a
    device. Returns (listed, [(`bases_on` the block's device, params,
    data, dropout generator, seed slice)])."""
    listed = isinstance(params, (list, tuple))
    if not listed:
        params, data = [params], [data]
    gens = block_gens if block_gens is not None else [gen] * len(params)
    if len(gens) != len(params):
        raise ValueError(f'{len(gens)} generators for {len(params)} blocks')
    bases = bases_on(base, [next(iter(p.values())).device for p in params])
    blocks, lo = [], 0
    for b, p, d, g in zip(bases, params, data, gens):
        n = next(iter(p.values())).shape[0]
        blocks.append((b, p, d, g, slice(lo, lo + n)))
        lo += n
    return listed, blocks


def bases_on(base: torch.nn.Module, devices) -> list:
    """``base`` for each of ``devices``: itself on its own device, one copy
    on each other device (its buffers are the seeds' shared ones, and
    `functional_call` reads them there)."""
    copies = {next(base.parameters()).device: base}
    for d in devices:
        if d not in copies:
            copies[d] = copy.deepcopy(base).to(d)
    return [copies[d] for d in devices]


def _column_orders(gen, blocks, n_seeds: int, n: int, batch_size: int):
    """One epoch's batch orders of the whole column from ``gen``
    (`column_batches`), each block's seeds' slice on its device."""
    order = column_batches(gen, n_seeds, n, batch_size)
    return [order[:, sl].to(next(iter(p.values())).device)
            for _, p, _, _, sl in blocks]


def fit_br_column(base: torch.nn.Module, params, data, cfg: TrainConfig,
                  gen: torch.Generator, block_gens=None):
    """`fit_br_model` for a column of S seeds at once: ``params`` (from
    `stack_nets`) train in place on ``data`` (tensors ``[S, N, ...]``, on
    the generator's device; short seeds zero-padded). Each batch is one
    vmapped forward of ``base`` and one gradient of the sum of the S
    per-seed losses (each seed's slice is its own gradient), both
    optimizers step every seed, clipping per seed; the EMA count is
    shared, as every seed takes ``N // batch_size`` batches. Dropout masks
    differ between the seeds and all come from ``gen``. Returns the EMA,
    stacked like ``params``.

    A sharded column passes ``params`` and ``data`` as lists, one block of
    consecutive seeds a device, and ``block_gens``, one generator a block
    on its device. Each block then trains as its own stacked fit on its
    device, with its own optimizers; ``gen`` draws the batch orders of the
    whole column, each block taking its seeds' slice, so they are the
    unsharded column's; each block's dropout masks come from its own
    generator. Returns one EMA a block."""
    listed, blocks = _seed_blocks(base, params, data, gen, block_gens)
    treat = treatment_head_mask(base)
    mode = cfg.treatment_mode
    n_seeds = sum(sl.stop - sl.start for *_, sl in blocks)
    n = next(iter(blocks[0][2].values())).shape[1]
    bs = min(cfg.batch_size, n)
    alphas = alpha_at_epoch(torch.arange(cfg.epochs), cfg.epochs, cfg.alpha,
                            cfg.alpha_rate, cfg.update_alpha)
    alphas = alphas.expand(cfg.epochs)

    def grads(loss, group):
        return torch.autograd.grad(loss, group, allow_unused=True,
                                   materialize_grads=True)

    states = []
    for b_base, b_params, b_data, b_gen, _ in blocks:
        def losses(p, batch, alpha, detach_treatment, b_base=b_base,
                   b_gen=b_gen):
            def one(p_s, b_s):
                tp, op, _ = functional_call(
                    b_base, p_s, (b_s, alpha),
                    {'gen': b_gen, 'detach_treatment': detach_treatment})
                if not detach_treatment:
                    mse_loss, bce_loss = br_losses(tp, op, b_s, alpha,
                                                   cfg.balancing, mode)
                    return mse_loss + bce_loss
                bce_elem = bce(tp, b_s['current_treatments'], mode)
                if cfg.balancing == 'domain_confusion':
                    bce_elem = alpha * bce_elem
                return masked_mean(bce_elem, b_s['active_entries'][..., 0])
            return torch.func.vmap(one, randomness='different')(
                p, batch).sum()

        group0 = [p for k, p in b_params.items() if not treat[k]]
        group1 = [p for k, p in b_params.items() if treat[k]]
        dev = next(iter(b_params.values())).device
        states.append(dict(
            params=b_params, data=b_data, losses=losses, group0=group0,
            group1=group1, opt0=_base_optimizer(group0, cfg),
            opt1=_base_optimizer(group1, cfg),
            ema={k: p.detach().clone() for k, p in b_params.items()},
            alphas=alphas.to(dev)))
    count = 0
    for epoch in range(cfg.epochs):
        orders = _column_orders(gen, blocks, n_seeds, n, bs)
        for i in range(orders[0].shape[0]):
            for st, order in zip(states, orders):
                batch = _gather_rows(st['data'], order[i])
                alpha, params_b, ema = (st['alphas'][epoch], st['params'],
                                        st['ema'])
                p = merge_by_mask(ema, params_b, treat) if cfg.weights_ema \
                    else params_b
                _step_column(st['opt0'], st['group0'],
                             grads(st['losses'](p, batch, alpha, False),
                                   st['group0']), cfg.max_grad_norm)
                p = merge_by_mask(params_b, ema, treat) if cfg.weights_ema \
                    else params_b
                _step_column(st['opt1'], st['group1'],
                             grads(st['losses'](p, batch, alpha, True),
                                   st['group1']), cfg.max_grad_norm)
            if cfg.weights_ema:
                for st in states:
                    _ema_update(list(st['ema'].values()),
                                list(st['params'].values()), count, cfg.beta)
                count += 1
    for st in states:
        for p in st['params'].values():
            p.grad = None
    emas = [st['ema'] for st in states]
    return emas if listed else emas[0]


def fit_simple_column(base: torch.nn.Module, params, loss_fn, data,
                      cfg: TrainConfig, gen: torch.Generator,
                      block_gens=None):
    """`fit_simple` for a column of S seeds at once: ``params`` (from
    `stack_nets`) train in place on ``data`` (tensors ``[S, N, ...]``, on
    the generator's device; short seeds zero-padded), one step a batch on
    the sum of the S per-seed ``loss_fn(net, batch, gen)``, where ``net``
    calls ``base`` with one seed's parameters; clipping per seed.
    Returns ``params``. A sharded column passes lists and
    ``block_gens``, as `fit_br_column` describes."""
    listed, blocks = _seed_blocks(base, params, data, gen, block_gens)
    n_seeds = sum(sl.stop - sl.start for *_, sl in blocks)
    n = next(iter(blocks[0][2].values())).shape[1]
    bs = min(cfg.batch_size, n)
    states = []
    for b_base, b_params, b_data, b_gen, _ in blocks:
        def loss(batch, b_base=b_base, b_params=b_params, b_gen=b_gen):
            def one(p_s, b_s):
                def net(*args, **kwargs):
                    return functional_call(b_base, p_s, args, kwargs)
                return loss_fn(net, b_s, b_gen)
            return torch.func.vmap(one, randomness='different')(
                b_params, batch).sum()

        trainable = list(b_params.values())
        states.append((loss, trainable, b_data,
                       _base_optimizer(trainable, cfg)))
    for _ in range(cfg.epochs):
        orders = _column_orders(gen, blocks, n_seeds, n, bs)
        for i in range(orders[0].shape[0]):
            for (loss, trainable, b_data, opt), order in zip(states,
                                                              orders):
                g = torch.autograd.grad(loss(_gather_rows(b_data, order[i])),
                                        trainable, allow_unused=True,
                                        materialize_grads=True)
                _step_column(opt, trainable, g, cfg.max_grad_norm)
    for _, trainable, _, _ in states:
        for p in trainable:
            p.grad = None
    return params


def device_batch(data: dict, keys, device, dtype) -> dict:
    """``data[k]`` for ``k`` in ``keys`` as tensors of ``dtype`` on
    ``device`` (on the host, a tensor may share the array's memory)."""
    return {k: torch.as_tensor(np.asarray(data[k]), dtype=dtype,
                               device=device) for k in keys}


def seeded_net(seed: int, build, device) -> torch.nn.Module:
    """``build()`` on the host with PyTorch's init drawn from ``seed`` alone
    (the host's global generator is restored afterwards), then moved to
    ``device``: one seed gives the same initial weights on every device,
    whatever drew from the global generator before."""
    with torch.random.fork_rng(devices=[]):
        torch.random.default_generator.manual_seed(seed)
        net = build()
    return net.to(device)


class BRStage(CausalEstimator):
    """A network trained by `fit_br_model` on a dataset's ``keys``, on
    ``device`` in ``dtype``, with a generator seeded with ``seed`` (and
    ``augment_fn`` passed on). It predicts from ``input_keys`` with the
    classifier's trained parameters and, with ``weights_ema``, the EMA of
    the rest. Each of ``optional_keys`` joins both where a dataset carries
    it."""

    def __init__(self, net: torch.nn.Module, train_cfg: TrainConfig,
                 seed: int, keys, input_keys, *, device, dtype,
                 optional_keys=(), augment_fn=None):
        self.net = net
        self.train_cfg = train_cfg
        self.seed = seed
        self.keys = keys
        self.input_keys = input_keys
        self.optional_keys = optional_keys
        self.augment_fn = augment_fn
        self.device = device
        self.dtype = dtype
        self.treat_mask = treatment_head_mask(net)
        self.ema_params = None

    def batch(self, data: dict, keys) -> dict:
        """`device_batch` of ``keys`` and of the optional keys ``data``
        carries."""
        keys = tuple(keys) + tuple(k for k in self.optional_keys
                                   if k in data and k not in keys)
        return device_batch(data, keys, self.device, self.dtype)

    def fit_stage(self, data: dict):
        batch = self.batch(data, self.keys)
        gen = torch.Generator(device=self.device).manual_seed(self.seed)
        self.ema_params = fit_br_model(self.net, batch, self.train_cfg, gen,
                                       self.augment_fn)
        return self

    def _predict_params(self) -> dict:
        params = {k: p.detach() for k, p in self.net.named_parameters()}
        if self.train_cfg.weights_ema and self.ema_params is not None:
            return merge_by_mask(params, self.ema_params, self.treat_mask)
        return params

    @torch.no_grad()
    def forward(self, batch: dict):
        """(treatment logits, outcome prediction, representation) of a
        batch of tensors."""
        return functional_call(self.net, self._predict_params(), (batch,))

    def predict_all(self, data: dict):
        """(outcome prediction, representation) of ``data``, numpy."""
        _, outputs, br = self.forward(self.batch(data, self.input_keys))
        return outputs.cpu().numpy(), br.cpu().numpy()

    def get_predictions(self, dataset) -> np.ndarray:
        return self.predict_all(dataset.data)[0]

    def get_representations(self, dataset) -> np.ndarray:
        return self.predict_all(dataset.data)[1]

    def get_attention_maps(self, dataset) -> dict:
        """{module path: [B, heads, Tq, Tk]}, numpy: each attention
        module's probabilities in a prediction pass over ``dataset``, its
        first call's where it is called more than once
        (`first_attention_maps`); {} for a network without attention."""
        batch = self.batch(dataset.data, self.input_keys)
        maps = first_attention_maps(self.net, lambda: self.forward(batch))
        return {k: v.cpu().numpy() for k, v in maps.items()}
