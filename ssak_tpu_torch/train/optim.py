"""Gradient transformations with optax's semantics, on dicts of tensors.

The JAX package trains with optax (`chain(clip_by_global_norm, adamw(
schedule))`, adadelta, multi_transform, MultiSteps, inject_hyperparams).
`torch.optim` differs from optax in ways a parity test sees: AdamW's decay
placement and epsilon, no clipping inside the optimizer, the schedule's
value at step 0, gradient accumulation. So the port carries the few optax
transforms it needs, written out here:

  * a transform has `init(params) -> state` and
    `update(grads, state, params) -> (updates, state)`; params, grads and
    updates are dicts name -> tensor, states nested dicts of tensors and
    Python numbers, None for a stateless transform (so a checkpoint stores
    them as they are);
  * `apply_updates` adds the updates to the parameters IN PLACE (optax
    returns new arrays; the port keeps one copy of the weights).

Scalars that optax computes in f32 on the device (schedule values, bias
corrections, the clip factor) are computed here in numpy f32 on the host or
in f32 tensors, so the updates agree with optax to f32 rounding.
"""

import re

import numpy as np
import torch


class Transform:
    def __init__(self, init, update):
        self.init = init
        self.update = update


def _f32(x) -> float:
    return float(np.float32(x))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (optax.global_norm)."""
    return torch.sqrt(sum(torch.sum(t.to(torch.float32) ** 2) for t in tensors))


def apply_updates(params: dict, updates: dict):
    """params[name] += updates[name], in place (optax.apply_updates)."""
    with torch.no_grad():
        for name, p in params.items():
            p.add_(updates[name].to(p.dtype))


def chain(*transforms) -> Transform:
    def init(params):
        return {str(i): t.init(params) for i, t in enumerate(transforms)}

    def update(grads, state, params):
        new = {}
        for i, t in enumerate(transforms):
            grads, new[str(i)] = t.update(grads, state[str(i)], params)
        return grads, new

    return Transform(init, update)


def clip_by_global_norm(max_norm: float) -> Transform:
    """g * max_norm / norm where norm >= max_norm, g untouched below it (no epsilon)."""

    def update(grads, state, params):
        norm = global_norm(grads.values())
        keep = norm < max_norm
        return {k: torch.where(keep, g, (g / norm) * max_norm) for k, g in grads.items()}, state

    return Transform(lambda params: None, update)


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Transform:
    def init(params):
        return {"count": 0, "mu": {k: torch.zeros_like(p) for k, p in params.items()},
                "nu": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        count = state["count"] + 1
        bc1 = _f32(np.float32(1) - np.float32(b1) ** np.float32(count))
        bc2 = _f32(np.float32(1) - np.float32(b2) ** np.float32(count))
        mu, nu, out = {}, {}, {}
        for k, g in grads.items():
            mu[k] = (1 - b1) * g + b1 * state["mu"][k]
            nu[k] = (1 - b2) * (g * g) + b2 * state["nu"][k]
            out[k] = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps)
        return out, {"count": count, "mu": mu, "nu": nu}

    return Transform(init, update)


def scale_by_adadelta(rho: float = 0.9, eps: float = 1e-6) -> Transform:
    def init(params):
        return {"e_g": {k: torch.zeros_like(p) for k, p in params.items()},
                "e_x": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        e_g, e_x, out = {}, {}, {}
        for k, g in grads.items():
            e_g[k] = (1 - rho) * (g * g) + rho * state["e_g"][k]
            out[k] = (torch.sqrt(state["e_x"][k] + eps) / torch.sqrt(e_g[k] + eps)) * g
            e_x[k] = (1 - rho) * (out[k] * out[k]) + rho * state["e_x"][k]
        return out, {"e_g": e_g, "e_x": e_x}

    return Transform(init, update)


def add_decayed_weights(weight_decay: float) -> Transform:
    def update(grads, state, params):
        if not weight_decay:
            return grads, state
        return {k: g + weight_decay * params[k] for k, g in grads.items()}, state

    return Transform(lambda params: None, update)


def scale_by_learning_rate(learning_rate) -> Transform:
    """Multiply by -lr; a callable lr is a schedule of the transform's own
    step count (0 at the first update, as optax.scale_by_schedule)."""
    if callable(learning_rate):
        def update(grads, state, params):
            step = -_f32(learning_rate(state["count"]))
            return {k: g * step for k, g in grads.items()}, {"count": state["count"] + 1}

        return Transform(lambda params: {"count": 0}, update)

    step = -_f32(learning_rate)
    return Transform(lambda params: None, lambda grads, state, params: ({k: g * step for k, g in grads.items()}, state))


def adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4) -> Transform:
    """optax.adamw: Adam, plus weight_decay * param (every parameter), times -lr."""
    return chain(scale_by_adam(b1, b2, eps), add_decayed_weights(weight_decay), scale_by_learning_rate(learning_rate))


def adadelta(learning_rate, rho=0.9, eps=1e-6) -> Transform:
    return chain(scale_by_adadelta(rho, eps), scale_by_learning_rate(learning_rate))


def multi_transform(transforms: dict, label_fn) -> Transform:
    """Each parameter goes to the transform its label names
    (label_fn(name) -> group), as optax.multi_transform."""

    def split(d):
        groups = {g: {} for g in transforms}
        for k, v in d.items():
            groups[label_fn(k)][k] = v
        return groups

    def init(params):
        return {g: transforms[g].init(ps) for g, ps in split(params).items()}

    def update(grads, state, params):
        out, new = {}, {}
        pg = split(params)
        for g, gs in split(grads).items():
            u, new[g] = transforms[g].update(gs, state[g], pg[g])
            out.update(u)
        return out, new

    return Transform(init, update)


def regex_labels(rules, default: str):
    """label_fn over /-joined module paths ('/lm_head/weight'): the first
    (pattern, group) whose pattern matches wins, else `default`."""

    def label(name):
        path = "/" + name.replace(".", "/")
        for pattern, group in rules:
            if re.search(pattern, path):
                return group
        return default

    return label


def inject_learning_rate(make, learning_rate: float) -> Transform:
    """A transform built by make(lr) whose lr sits in its state
    (state["hyperparams"]["lr"]) and may be changed between updates
    (optax.inject_hyperparams)."""

    def init(params):
        return {"hyperparams": {"lr": _f32(learning_rate)}, "inner_state": make(_f32(learning_rate)).init(params)}

    def update(grads, state, params):
        lr = state["hyperparams"]["lr"]
        updates, inner = make(lr).update(grads, state["inner_state"], params)
        return updates, {"hyperparams": dict(state["hyperparams"]), "inner_state": inner}

    return Transform(init, update)


def multi_steps(inner: Transform, every: int) -> Transform:
    """Gradient accumulation (optax.MultiSteps, mean of the micro-step
    gradients by Welford updates): the inner transform updates once every
    `every` calls, on the mean gradient; the other calls return zeros."""

    def init(params):
        return {"mini_step": 0, "gradient_step": 0, "inner_opt_state": inner.init(params),
                "acc_grads": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(grads, state, params):
        n = state["mini_step"]
        acc = {k: state["acc_grads"][k] + (g - state["acc_grads"][k]) / (n + 1) for k, g in grads.items()}
        if n == every - 1:
            updates, inner_state = inner.update(acc, state["inner_opt_state"], params)
            return updates, {"mini_step": 0, "gradient_step": state["gradient_step"] + 1, "inner_opt_state": inner_state,
                             "acc_grads": {k: torch.zeros_like(a) for k, a in acc.items()}}
        updates = {k: torch.zeros_like(g) for k, g in grads.items()}
        return updates, {**state, "mini_step": n + 1, "acc_grads": acc}

    return Transform(init, update)


# --- schedules (optax's, evaluated in f32) ---------------------------------------------


def linear_schedule(init_value: float, end_value: float, transition_steps: int):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count):
        c = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - c / np.float32(transition_steps)
        return np.float32(init_value - end_value) * frac + np.float32(end_value)

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0):
    if not decay_steps > 0:
        raise ValueError(f"The cosine_decay_schedule requires positive decay_steps, got decay_steps={decay_steps}.")

    def schedule(count):
        c = np.float32(min(count, decay_steps))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(np.pi) * c / np.float32(decay_steps)))
        return np.float32(init_value) * (np.float32(1 - alpha) * cosine + np.float32(alpha))

    return schedule


def join_schedules(schedules, boundaries):
    def schedule(count):
        out = schedules[0](count)
        for boundary, s in zip(boundaries, schedules[1:]):
            if count >= boundary:
                out = s(count - boundary)
        return out

    return schedule


def warmup_cosine_decay_schedule(init_value, peak_value, warmup_steps, decay_steps, end_value=0.0):
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    return join_schedules([linear_schedule(init_value, peak_value, warmup_steps),
                           cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)], [warmup_steps])
