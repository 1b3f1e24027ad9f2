"""JAX variables -> the port's state_dict, and the port's state_dict to and
from the oracle's.

The port's module names mirror the flax tree, so conversion is mechanics:
  params    a/b/kernel (kh,kw,I,O)  -> "a.b.weight" (O,I,kh,kw)
  params    a/b/scale, a/b/bias     -> "a.b.weight", "a.b.bias"
  batch_stats a/b/mean, a/b/var     -> "a.b.running_mean", "a.b.running_var"
  params    name (a top-level leaf, ``stage_log_var``) -> "name"
The input is the JAX package's ``{params, batch_stats}`` as nested dicts of
numpy arrays (or anything ``np.asarray`` reads); nothing of JAX is imported.
``optimizer_state_from_jax`` carries optax's SGD momentum (the ``trace``,
params-shaped) across the same way, into ``torch.optim.SGD``'s
``momentum_buffer``s: both packages' SGD keep v = mu*v + (g + wd*p).

``graft_pretrained_encoders`` is the port's own copy of ``radar_depth_tpu/
utils/torch_convert.py::graft_pretrained_encoders`` (``--pretrained``): a
torchvision ResNet state_dict into every encoder of a model, on torch
state_dicts.

``oracle_state_dict_from_port`` / ``port_state_dict_from_oracle`` map the
port's state_dict to and from the names and layouts of the reference's
torch modules (``radar_depth_tpu/oracle/torch_model.py``; the JAX package's
``variables_to_torch_state_dict`` / ``torch_state_dict_to_variables``).
The names are the same; only a transposed conv (module ``convt``,
``nn.ConvTranspose2d``) differs, (I,O,k,k) there against the port's
(O,I,k,k). An ``UnpoolConv`` holds the oracle's ``nn.Conv2d`` layout
already.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

_LEAF = {("params", "scale"): "weight", ("params", "bias"): "bias",
         ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _flatten(tree: Mapping, prefix=()) -> Dict[tuple, Any]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def state_dict_from_jax_variables(
        variables: Mapping,
        like: Mapping[str, torch.Tensor] | None = None) -> Dict[str, torch.Tensor]:
    """{params, batch_stats} -> state_dict of float32 CPU tensors.

    Raises on an unknown leaf and, when ``like`` (the target model's
    ``state_dict()``) is given, on any missing or extra key and any shape
    mismatch."""
    sd: Dict[str, torch.Tensor] = {}
    for col in ("params", "batch_stats"):
        for path, w in _flatten(variables.get(col, {})).items():
            *mods, leaf = path
            w = np.asarray(w, dtype=np.float32)
            if col == "params" and leaf == "kernel":
                if w.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: kernel of rank {w.ndim}")
                leaf, w = "weight", w.transpose(3, 2, 0, 1)
            elif (col, leaf) in _LEAF:
                leaf = _LEAF[col, leaf]
            elif col != "params" or mods:  # else a parameter of the model
                raise KeyError(f"unknown {col} leaf {'/'.join(path)}")
            sd[".".join([*mods, leaf])] = torch.tensor(w)
    if like is not None:
        _check_like(sd, like)
    return sd


def _check_like(sd: Mapping[str, torch.Tensor],
                like: Mapping[str, torch.Tensor]) -> None:
    """Raise on a key of ``sd`` missing from or extra to ``like``, or a
    shape that differs."""
    missing = sorted(set(like) - set(sd))
    extra = sorted(set(sd) - set(like))
    if missing or extra:
        raise KeyError(f"state_dict keys differ: missing {missing[:5]}"
                       f"{'...' if len(missing) > 5 else ''}, extra "
                       f"{extra[:5]}{'...' if len(extra) > 5 else ''}")
    for k, t in like.items():
        if tuple(t.shape) != tuple(sd[k].shape):
            raise ValueError(f"{k}: shape {tuple(sd[k].shape)} != "
                             f"{tuple(t.shape)}")


def optimizer_state_from_jax(opt_state_trace: Mapping, like) -> Dict[str, Any]:
    """optax's SGD ``trace`` (nested dicts of numpy, flax names, the shape
    of ``params``) -> a state_dict for ``like.optimizer``, ``like`` the
    port's ``train.state.TrainState``: one float32 ``momentum_buffer`` per
    parameter of ``like.model``, in its parameter order, and the optimizer's
    own param_groups. Raises on a missing or extra key or a shape
    mismatch."""
    names = [n for n, _ in like.model.named_parameters()]
    bufs = state_dict_from_jax_variables(
        {"params": opt_state_trace},
        like={n: p.detach() for n, p in like.model.named_parameters()})
    return {"state": {i: {"momentum_buffer": bufs[n]}
                      for i, n in enumerate(names)},
            "param_groups": like.optimizer.state_dict()["param_groups"]}


def torchvision_resnet_to_encoder(state_dict: Mapping[str, Any]
                                  ) -> Dict[str, torch.Tensor]:
    """A torchvision ResNet-18/34/50 state_dict -> the port's encoder names
    (``layer{s}.{b}.`` -> ``layer{s}_{b}.``, ``downsample.{0,1}`` ->
    ``downsample_{conv,bn}``), without the classifier (``fc.``) and
    torchvision's ``num_batches_tracked`` counters."""
    out = {}
    for k, v in state_dict.items():
        if k.startswith("fc.") or k.endswith("num_batches_tracked"):
            continue
        for s in range(1, 5):
            for b in range(6):
                k = k.replace(f"layer{s}.{b}.", f"layer{s}_{b}.")
        k = k.replace(".downsample.0.", ".downsample_conv.").replace(
            ".downsample.1.", ".downsample_bn.")
        out[k] = torch.as_tensor(v)
    return out


def graft_pretrained_encoders(model_state: Mapping[str, torch.Tensor],
                              state_dict: Mapping[str, Any]) -> tuple:
    """Graft a torchvision ResNet state_dict into every encoder of a model
    (the reference's pretrained=True: all backbone weights from ImageNet; a
    conv1 whose input channels differ, as the 4-channel early fusion or the
    1-channel radar branch, keeps its fresh initialisation).

    ``model_state`` is the model's ``state_dict()``. Returns (new state_dict,
    report) with report a list of (encoder, tensors loaded, skipped), the
    encoder named as in the flax tree ("stage1/img_encoder") and each
    skipped tensor as "name (missing)" or "name (shape)", as the JAX
    function reports them."""
    src = torchvision_resnet_to_encoder(state_dict)
    prefixes = sorted({k[:k.index("encoder.") + len("encoder")]
                       for k in model_state if "encoder." in k})
    out = dict(model_state)
    report = []
    for prefix in prefixes:
        loaded, skipped = 0, []
        for key, tmpl in model_state.items():
            if not key.startswith(prefix + "."):
                continue
            name = key[len(prefix) + 1:]
            if name not in src:
                skipped.append(f"{name} (missing)")
            elif tuple(src[name].shape) != tuple(tmpl.shape):
                skipped.append(f"{name} (shape)")
            else:
                out[key] = src[name].to(torch.float32).clone()
                loaded += 1
        report.append((prefix.replace(".", "/"), loaded, skipped))
    return out, report


_ORACLE_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _swap_convt(state_dict: Mapping[str, Any], to: str
                ) -> Dict[str, torch.Tensor]:
    """float32 contiguous CPU tensors under the same names, each ``convt``
    weight's first two axes swapped ((O,I,k,k) in the port, (I,O,k,k) in
    the oracle's ``nn.ConvTranspose2d``). Raises KeyError on a leaf that
    ``to`` has no counterpart for."""
    sd: Dict[str, torch.Tensor] = {}
    for key, t in state_dict.items():
        if "." not in key or key.rsplit(".", 1)[1] not in _ORACLE_LEAVES:
            raise KeyError(f"{key}: no counterpart in the {to}'s modules")
        t = torch.as_tensor(t).detach().to("cpu", torch.float32)
        if key.endswith(".convt.weight"):
            t = t.transpose(0, 1)
        sd[key] = t.contiguous()
    return sd


def oracle_state_dict_from_port(state_dict: Mapping[str, Any]
                                ) -> Dict[str, torch.Tensor]:
    """The port's state_dict -> the oracle's (the JAX package's
    ``variables_to_torch_state_dict``). Raises KeyError on the
    ``_uncertainty`` archs' top-level ``stage_log_var``, which the oracle
    lacks."""
    return _swap_convt(state_dict, "oracle")


def port_state_dict_from_oracle(
        state_dict: Mapping[str, Any],
        like: Mapping[str, torch.Tensor] | None = None) -> Dict[str, torch.Tensor]:
    """The oracle's state_dict -> the port's (the JAX package's
    ``torch_state_dict_to_variables``), without ``nn.BatchNorm2d``'s
    ``num_batches_tracked`` counters, which no module of the port (nor of
    the JAX package) holds. Raises KeyError on any other leaf the port
    lacks and, when ``like`` (the target model's ``state_dict()``) is
    given, on any missing or extra key, and ValueError on any shape
    mismatch."""
    sd = _swap_convt({k: v for k, v in state_dict.items()
                      if not k.endswith(".num_batches_tracked")}, "port")
    if like is not None:
        _check_like(sd, like)
    return sd
