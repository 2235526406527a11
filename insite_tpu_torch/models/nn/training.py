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
    mse = (outcome_pred - batch['outputs']) ** 2
    active = batch['active_entries']
    mse_loss = masked_mean(mse, active)
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
    return mse_loss, masked_mean(bce_elem, active[..., 0])


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


def fit_br_column(base: torch.nn.Module, params: dict, data: dict,
                  cfg: TrainConfig, gen: torch.Generator) -> dict:
    """`fit_br_model` for a column of S seeds at once: ``params`` (from
    `stack_nets`) train in place on ``data`` (tensors ``[S, N, ...]``, on
    the generator's device; short seeds zero-padded). Each batch is one
    vmapped forward of ``base`` and one gradient of the sum of the S
    per-seed losses (each seed's slice is its own gradient), both
    optimizers step every seed, clipping per seed; the EMA count is
    shared, as every seed takes ``N // batch_size`` batches. Dropout masks
    differ between the seeds and all come from ``gen``. Returns the EMA,
    stacked like ``params``."""
    treat = treatment_head_mask(base)
    group0 = [p for k, p in params.items() if not treat[k]]
    group1 = [p for k, p in params.items() if treat[k]]
    opt0 = _base_optimizer(group0, cfg)
    opt1 = _base_optimizer(group1, cfg)
    ema = {k: p.detach().clone() for k, p in params.items()}
    ema_list, param_list = list(ema.values()), list(params.values())
    mode = cfg.treatment_mode

    def losses(p, batch, alpha, detach_treatment):
        def one(p_s, b_s):
            tp, op, _ = functional_call(
                base, p_s, (b_s, alpha),
                {'gen': gen, 'detach_treatment': detach_treatment})
            if not detach_treatment:
                mse_loss, bce_loss = br_losses(tp, op, b_s, alpha,
                                               cfg.balancing, mode)
                return mse_loss + bce_loss
            bce_elem = bce(tp, b_s['current_treatments'], mode)
            if cfg.balancing == 'domain_confusion':
                bce_elem = alpha * bce_elem
            return masked_mean(bce_elem, b_s['active_entries'][..., 0])
        return torch.func.vmap(one, randomness='different')(p, batch).sum()

    def grads(loss, group):
        return torch.autograd.grad(loss, group, allow_unused=True,
                                   materialize_grads=True)

    S, n = next(iter(data.values())).shape[:2]
    bs = min(cfg.batch_size, n)
    alphas = alpha_at_epoch(torch.arange(cfg.epochs), cfg.epochs, cfg.alpha,
                            cfg.alpha_rate, cfg.update_alpha)
    alphas = alphas.expand(cfg.epochs).to(gen.device)
    count = 0
    for epoch in range(cfg.epochs):
        alpha = alphas[epoch]
        for idx in column_batches(gen, S, n, bs):
            batch = _gather_rows(data, idx)
            p = merge_by_mask(ema, params, treat) if cfg.weights_ema \
                else params
            _step_column(opt0, group0,
                         grads(losses(p, batch, alpha, False), group0),
                         cfg.max_grad_norm)
            p = merge_by_mask(params, ema, treat) if cfg.weights_ema \
                else params
            _step_column(opt1, group1,
                         grads(losses(p, batch, alpha, True), group1),
                         cfg.max_grad_norm)
            if cfg.weights_ema:
                count = _ema_update(ema_list, param_list, count, cfg.beta)
    for p in param_list:
        p.grad = None
    return ema


def fit_simple_column(base: torch.nn.Module, params: dict, loss_fn,
                      data: dict, cfg: TrainConfig,
                      gen: torch.Generator) -> dict:
    """`fit_simple` for a column of S seeds at once: ``params`` (from
    `stack_nets`) train in place on ``data`` (tensors ``[S, N, ...]``, on
    the generator's device; short seeds zero-padded), one step a batch on
    the sum of the S per-seed ``loss_fn(net, batch, gen)``, where ``net``
    calls ``base`` with one seed's parameters; clipping per seed.
    Returns ``params``."""
    trainable = list(params.values())
    opt = _base_optimizer(trainable, cfg)

    def loss(batch):
        def one(p_s, b_s):
            def net(*args, **kwargs):
                return functional_call(base, p_s, args, kwargs)
            return loss_fn(net, b_s, gen)
        return torch.func.vmap(one, randomness='different')(
            params, batch).sum()

    S, n = next(iter(data.values())).shape[:2]
    bs = min(cfg.batch_size, n)
    for _ in range(cfg.epochs):
        for idx in column_batches(gen, S, n, bs):
            g = torch.autograd.grad(loss(_gather_rows(data, idx)), trainable,
                                    allow_unused=True,
                                    materialize_grads=True)
            _step_column(opt, trainable, g, cfg.max_grad_norm)
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
