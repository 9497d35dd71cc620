"""Weight bridge: JAX (flax) variables -> the port's state_dicts.

load_jax_variables takes one net's variables as nested dicts of numpy arrays,
{"params": ..., "batch_stats": ..., "spectral": ...}.  The port's modules
carry the flax names (nn/blocks.py), so the mapping is keyed on names, never
on dict order (jit round trips alphabetize keys):

  params/<path>/kernel  HWIO / DHWIO / (in,out) -> <path>.weight OIHW / OIDHW / (out,in)
  params/<path>/bias                            -> <path>.bias
  params/<path>/weight  (the ELR and WN / UB layers, torch's layouts already)
                                                -> <path>.weight, as it is
  params/<path>/g       (the WN layers' gain)   -> <path>.g
  params/<path>/scale   (BatchNorm, InstanceNorm)-> <path>.weight
  batch_stats/<path>/mean, var                  -> <path>.running_mean, .running_var
  spectral/<path>/u                             -> <path>.weight_u
  spectral/<path>/v     (K..., I) flattening     -> <path>.weight_v in (I, K...) order

The way back needs to know which weights are kept as they are:
weight_as_is(net) lists them (nn/elr.py and nn/wn.py mark their classes).
A bias goes as it is either way, the untied biases' [*spatial, out] too.

It is strict: a leaf with no counterpart, a parameter with no leaf, or a shape
mismatch raises ValueError.

load_jax_train_state carries a whole JAX train state across (g_params,
d_params, c_params, teachers, batch_stats, spectral), net by net through
load_jax_variables, and with optimizers given, optax's Adam states too
(mu, nu -> exp_avg, exp_avg_sq by the same name map, count -> each
parameter's step).  The teachers (Hopenet, the perceptual
loss's VGG stacks) come this way: the port never draws teacher weights of
its own for parity.

The way back, for the port's own checkpoints in the JAX package's format:
jax_tree_from_state_dict inverts state_dict_from_jax (a weight of rank 2
or more -> kernel, a 1-D weight -> scale, running_mean/var -> batch_stats,
weight_u/v -> spectral u/v in the (K..., I) flattening), and
adam_state_dicts / optax_adam_tree give a torch Adam's state in optax's
ScaleByAdamState layout.

A JAX leaf or collection with no name in the map raises UnmappedLeaf, both a
ValueError and a KeyError (the teacher files of losses/pretrained.py raise
KeyError for a key with no leaf, as the JAX package does).
"""
from __future__ import annotations

import re
from typing import Any, Collection, Dict, FrozenSet, Iterator, Mapping, Tuple

import numpy as np
import torch


def natural_key(s: str):
    """Sort key under which Conv_10 follows Conv_9."""
    return [int(p) if p.isdigit() else p for p in re.split(r"(\d+)", s)]


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()) -> Iterator:
    for k in sorted(tree, key=natural_key):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def nested_from_flat(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """{"a/b/c": x} -> {"a": {"b": {"c": x}}} (e.g. the leaves of an .npz)."""
    out: Dict[str, Any] = {}
    for key, v in flat.items():
        node = out
        *path, leaf = key.split(sep)
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = v
    return out


def _torch_kernel(k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:                                  # Dense (in, out)
        return k.T
    if k.ndim in (4, 5):                             # (*k, I, O) -> (O, I, *k)
        nd = k.ndim - 2
        return k.transpose((nd + 1, nd) + tuple(range(nd)))
    raise ValueError(f"unexpected kernel rank {k.ndim}")


def _jax_kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 2:                                  # (out, in) -> Dense (in, out)
        return w.T
    if w.ndim in (4, 5):                             # (O, I, *k) -> (*k, I, O)
        nd = w.ndim - 2
        return w.transpose(tuple(range(2, nd + 2)) + (1, 0))
    raise ValueError(f"unexpected weight rank {w.ndim}")


class UnmappedLeaf(KeyError, ValueError):
    """A JAX leaf or variable collection that the name map does not know."""


def state_dict_from_jax(variables: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Map one net's JAX variables to a {state_dict key: numpy array} dict."""
    collections = set(variables) - {"params", "batch_stats", "spectral"}
    if collections:
        raise UnmappedLeaf(f"unknown variable collections {sorted(collections)}")
    out: Dict[str, np.ndarray] = {}
    kernels: Dict[Tuple[str, ...], np.ndarray] = {}

    def put(path, name, value):
        key = ".".join(path + (name,))
        if key in out:
            raise ValueError(f"two JAX leaves map to {key}")
        out[key] = np.ascontiguousarray(value)

    leaf_names = {"params": {"kernel": "weight", "bias": "bias", "scale": "weight",
                             "weight": "weight", "g": "g"},
                  "batch_stats": {"mean": "running_mean", "var": "running_var"},
                  "spectral": {"u": "weight_u", "v": "weight_v"}}
    for col in ("params", "batch_stats", "spectral"):
        for path, a in _leaves(variables.get(col, {})):
            mod, leaf = path[:-1], path[-1]
            if leaf not in leaf_names[col]:
                raise UnmappedLeaf(f"unmapped JAX leaf {col}/{'/'.join(path)}")
            if col == "params" and leaf == "kernel":
                kernels[mod] = a
                a = _torch_kernel(a)
            elif col == "spectral" and leaf == "v":
                if mod not in kernels:
                    raise ValueError(f"spectral v at {'/'.join(mod)} has no kernel")
                k = kernels[mod]
                nd = k.ndim - 2                       # v is (*k, I) flattened
                a = (a.reshape(k.shape[:-1])
                     .transpose((nd,) + tuple(range(nd))).reshape(-1))
            put(mod, leaf_names[col][leaf], a)
    return out


def weight_as_is(net: torch.nn.Module) -> FrozenSet[str]:
    """The state_dict keys of ``net``'s ELR and WN / UB weights, which the
    JAX package stores as "weight" leaves in torch's layout."""
    return frozenset(f"{name}.weight" if name else "weight" for name, m in net.named_modules()
                     if getattr(m, "weight_as_is", False))


def jax_tree_from_state_dict(sd: Mapping[str, Any],
                             as_is: Collection[str] = ()) -> Dict[str, Any]:
    """The inverse of state_dict_from_jax: one net's {state_dict key: numpy
    array} -> its JAX variables {"params", "batch_stats", "spectral"} as
    nested numpy (collections that would be empty left out).  The keys in
    ``as_is`` (weight_as_is) go to "weight" leaves unchanged."""
    out: Dict[str, Dict[str, Any]] = {}
    names = {"bias": ("params", "bias"), "g": ("params", "g"),
             "running_mean": ("batch_stats", "mean"),
             "running_var": ("batch_stats", "var"), "weight_u": ("spectral", "u"),
             "weight_v": ("spectral", "v")}
    for key in sorted(sd, key=natural_key):
        a = np.asarray(sd[key])
        *mod, leaf = key.split(".")
        if key in as_is:
            col, name = "params", "weight"
        elif leaf == "weight":
            col, name = ("params", "kernel") if a.ndim >= 2 else ("params", "scale")
            a = _jax_kernel(a) if a.ndim >= 2 else a
        elif leaf in names:
            col, name = names[leaf]
        else:
            raise UnmappedLeaf(f"state_dict key {key} has no JAX leaf")
        if leaf == "weight_v":
            w = sd.get(".".join(mod + ["weight"]))
            if w is None:
                raise ValueError(f"{key} has no weight")
            shape = tuple(w.shape[1:])                  # v is (I, *k) flattened
            nd = len(shape) - 1
            a = a.reshape(shape).transpose(tuple(range(1, nd + 1)) + (0,)).reshape(-1)
        node = out.setdefault(col, {})
        for m in mod:
            node = node.setdefault(m, {})
        node[name] = np.ascontiguousarray(a)
    return out


def load_jax_variables(model: torch.nn.Module, variables: Mapping[str, Any]):
    """Copy one net's JAX variables into ``model`` (on its device), strictly."""
    new = state_dict_from_jax(variables)
    own = model.state_dict()
    missing = sorted(set(own) - set(new), key=natural_key)
    extra = sorted(set(new) - set(own), key=natural_key)
    if missing or extra:
        raise ValueError(f"{type(model).__name__}: parameters with no JAX leaf "
                         f"{missing}; JAX leaves with no parameter {extra}")
    for k, v in new.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError(f"{type(model).__name__}.{k}: JAX shape {v.shape} vs "
                             f"port shape {tuple(own[k].shape)}")
    model.load_state_dict({k: torch.from_numpy(v).to(own[k].dtype)
                           for k, v in new.items()}, strict=True)
    return model


TRAIN_STATE_KEYS = ("g_params", "d_params", "c_params", "teachers", "batch_stats", "spectral")


def net_variables(tree: Mapping[str, Any], name: str) -> Dict[str, Any]:
    """One net's JAX variables out of a train-state tree: a teacher's own
    tree, or the net's params with its batch_stats and spectral trees."""
    if name in tree["teachers"]:
        return tree["teachers"][name]
    for col in ("g_params", "d_params", "c_params"):
        if name in tree[col]:
            variables = {"params": tree[col][name]}
            for c in ("batch_stats", "spectral"):
                if name in tree[c]:
                    variables[c] = tree[c][name]
            return variables
    raise ValueError(f"the train state has no net {name!r}")


def _named_params(opt: torch.optim.Optimizer, nets: Mapping[str, torch.nn.Module]):
    """[(net, key, parameter)] of ``opt`` in its own order (the order of its
    state_dict's indices), each parameter named by the net holding it."""
    names = {id(p): (n, k) for n, net in nets.items() for k, p in net.named_parameters()}
    out = []
    for group in opt.param_groups:
        for p in group["params"]:
            if id(p) not in names:
                raise ValueError(f"an optimizer parameter of shape {tuple(p.shape)} is "
                                 "in none of the nets")
            out.append(names[id(p)] + (p,))
    covered = {n for n, _, _ in out}
    for n in covered:
        own = {k for k, _ in nets[n].named_parameters()}
        stepped = {k for m, k, _ in out if m == n}
        if own != stepped:
            raise ValueError(f"the optimizer holds part of {n}: lacks {sorted(own - stepped)}")
    return out


def _optax_adam_state(opt: torch.optim.Adam, nets: Mapping[str, torch.nn.Module],
                      adam: Mapping[str, Any]) -> Dict[int, Dict[str, torch.Tensor]]:
    """The state of torch Adam ``opt`` (over whole nets of ``nets``) that
    optax's ScaleByAdamState ``adam`` ({"count", "mu", "nu"}, mu and nu
    keyed by net as the nets' params, nested numpy) holds, by the index of
    ``opt``'s state_dict; strictly: mu and nu must cover the same nets as
    ``opt``, leaf for leaf.  exp_avg / exp_avg_sq are mu / nu through the
    params' name map, each parameter's step is count: the two make the same
    update, lr * m_hat / (sqrt(v_hat) + eps).  A count of 0 gives no state,
    as a fresh torch Adam has."""
    if set(adam) != {"count", "mu", "nu"}:
        raise ValueError(f"an optax Adam state has count, mu, nu; got {sorted(adam)}")
    named = _named_params(opt, nets)
    covered = sorted({n for n, _, _ in named})
    moments = {}
    for m in ("mu", "nu"):
        if sorted(adam[m]) != covered:
            raise ValueError(f"optax {m} covers {sorted(adam[m])}, the optimizer {covered}")
        moments[m] = {n: state_dict_from_jax({"params": adam[m][n]}) for n in covered}
        for n in covered:
            own = {k for k, _ in nets[n].named_parameters()}
            if set(moments[m][n]) != own:
                raise ValueError(f"optax {m}/{n} and the parameters differ: "
                                 f"{sorted(set(moments[m][n]) ^ own)}")
    count = int(np.asarray(adam["count"]))
    # a capturable Adam (the port's on the card) keeps its step count on the
    # parameters' device, torch's default on the host
    capturable = any(g.get("capturable", False) for g in opt.param_groups)
    state = {}
    for i, (n, k, p) in enumerate(named):
        mu, nu = moments["mu"][n][k], moments["nu"][n][k]
        if tuple(mu.shape) != tuple(p.shape) or tuple(nu.shape) != tuple(p.shape):
            raise ValueError(f"optax moments of {n}.{k}: {mu.shape}, {nu.shape} vs {tuple(p.shape)}")
        if count:
            state[i] = {"step": torch.tensor(float(count), dtype=torch.float32,
                                             device=p.device if capturable else "cpu"),
                        "exp_avg": torch.tensor(mu, dtype=p.dtype, device=p.device),
                        "exp_avg_sq": torch.tensor(nu, dtype=p.dtype, device=p.device)}
    return state


def adam_state_dicts(opt: torch.optim.Adam, nets: Mapping[str, torch.nn.Module]):
    """A torch Adam's state by name: (count, {net: {key: exp_avg}}, {net:
    {key: exp_avg_sq}}), tensors where they lie (a parameter with no state
    yet: zeros).  count is the step every stepped parameter shares (0 for
    none); parameters that disagree raise."""
    mu: Dict[str, Dict[str, torch.Tensor]] = {}
    nu: Dict[str, Dict[str, torch.Tensor]] = {}
    steps = set()
    for n, k, p in _named_params(opt, nets):
        st = opt.state.get(p, {})
        if st:
            steps.add(int(st["step"]))
        mu.setdefault(n, {})[k] = st["exp_avg"].detach() if st else torch.zeros_like(p.detach())
        nu.setdefault(n, {})[k] = st["exp_avg_sq"].detach() if st else torch.zeros_like(p.detach())
    if len(steps) > 1:
        raise ValueError(f"the optimizer's parameters are at different steps {sorted(steps)}")
    return (steps.pop() if steps else 0), mu, nu


def optax_adam_tree(count: int, mu: Mapping[str, Mapping[str, Any]],
                    nu: Mapping[str, Mapping[str, Any]],
                    as_is: Mapping[str, Collection[str]] = None) -> Dict[str, Any]:
    """adam_state_dicts' result (numpy leaves) in optax's ScaleByAdamState
    layout: {"count": int32, "mu": {net: params tree}, "nu": ...};
    ``as_is`` maps a net to its weight_as_is keys."""
    def tree(sd, n):
        return jax_tree_from_state_dict(sd, (as_is or {}).get(n, ())).get("params", {})
    return {"count": np.asarray(count, np.int32),
            "mu": {n: tree(sd, n) for n, sd in mu.items()},
            "nu": {n: tree(sd, n) for n, sd in nu.items()}}


def load_jax_train_state(nets: Mapping[str, torch.nn.Module], tree: Mapping[str, Any],
                         optimizers: Mapping[str, torch.optim.Adam] = None):
    """Copy a JAX TrainState's variables (``tree``: a mapping with
    TRAIN_STATE_KEYS, nested numpy) into the port's ``nets`` (keyed by the
    JAX names), strictly: every net of ``nets`` must be filled, and every
    tree of ``tree`` must have a net.  ``optimizers`` ({"g_opt": Adam,
    "d_opt": Adam}) are filled from the tree's optax states of those names
    (chain(scale_by_adam, scale): {"0": ScaleByAdamState, "1": {}})."""
    missing = [k for k in TRAIN_STATE_KEYS + tuple(optimizers or ()) if k not in tree]
    if missing:
        raise ValueError(f"train state lacks {missing}")
    params = {**tree["g_params"], **tree["d_params"], **tree["c_params"]}
    teachers = dict(tree["teachers"])
    stray = (set(tree["batch_stats"]) | set(tree["spectral"])) - set(params)
    unknown = (set(params) | set(teachers)) - set(nets)
    unfilled = set(nets) - set(params) - set(teachers)
    if stray or unknown or unfilled:
        raise ValueError(f"train state and nets differ: state trees with no params {sorted(stray)}, "
                         f"nets the port lacks {sorted(unknown)}, "
                         f"port nets with no state {sorted(unfilled)}")
    adam = {}                          # checked before any net is filled
    for key, opt in (optimizers or {}).items():
        chain = tree[key]
        if set(chain) != {"0", "1"} or len(chain["1"]):
            raise ValueError(f"{key} is not optax.adam's state (chain of scale_by_adam "
                             f"and an empty scale state): keys {sorted(chain)}")
        adam[key] = _optax_adam_state(opt, nets, chain["0"])
    for name in list(params) + list(teachers):
        load_jax_variables(nets[name], net_variables(tree, name))
    for key, state in adam.items():
        opt = optimizers[key]
        opt.load_state_dict({"state": state, "param_groups": opt.state_dict()["param_groups"]})
    return nets
