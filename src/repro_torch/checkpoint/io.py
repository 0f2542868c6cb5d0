"""msgpack checkpoints of a federation, in the reference's file format.

Layout: ``<dir>/step_<n>.msgpack``, each file one self-describing tree
where an array is ``{"__nd__": shape, "dtype": numpy's name, "data":
bytes}``, a dict ``{"__map__": ...}`` (keys sorted, as the reference's
pytree flattening leaves them), a list or tuple ``{"__seq__": [...],
"tuple": bool}`` and anything else ``{"__leaf__": value}``. Writes go to
a temporary file renamed over the target, so a killed run never leaves a
torn checkpoint.

The files cross-load with the reference's ``repro.checkpoint``:

  * cohort params and optimizer states are in the reference's layout
    (``repro_torch.convert``): the ResNet's convolutions HIO, each
    optimizer moment a pytree shaped like the params, the state tagged
    ``{"__nt__": "SGDState" | "AdamState", ...}``;
  * the reference's threefry key (``"rng"``) is never written. The port
    writes its own draws' state under ``"torch"``: the federation's
    ``torch.Generator`` state, and, when the client runtime is passed,
    its inner-step count (the ``batch_indices`` seam's ``step``) and the
    clients ever woken. The generator state is restored only into a
    generator of the same device type (the card's and the CPU's draw
    differently anyway). The reference's restore ignores that key and
    keeps its own key;
  * reading a reference file, the port leaves its generator alone and
    takes the seam's step as ``round * local_steps``: the inner steps of
    a synchronous run saved after ``round`` rounds (the reference's own
    ``federate --ckpt`` and resume both save so).

Arrays are read without copying them out of the file's buffer, then put
on the federation's device once.

bf16 crosses both ways bit for bit. numpy has no bfloat16: a bf16
tensor is written as the reference writes a bf16 array, ``dtype:
"bfloat16"`` with its 2-byte bits, and such an entry (the port's or the
reference's) is read through a ``uint16`` view and comes back as a CPU
``torch.bfloat16`` tensor over the file's buffer, never through
``np.dtype("bfloat16")`` (which only ``ml_dtypes`` registers). Every
other array comes back as numpy; ``convert.lm_tree_from_numpy`` takes
both kinds of leaf.
"""
from __future__ import annotations

import os
import re
import tempfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.convert import (opt_state_from_numpy, opt_state_to_numpy,
                                 tensors_from_numpy, tensors_to_numpy)
from repro_torch.sharding import repad_cohort_arrays


class ZooMismatchError(ValueError):
    """A checkpoint's cohort families don't match the live federation's
    zoo. Raised before any state is assigned, naming the families missing
    on each side. Subclasses ValueError."""


def _encode(obj: Any):
    if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
        bits = obj.detach().cpu().contiguous().view(torch.int16).numpy()
        return {"__nd__": list(obj.shape), "dtype": "bfloat16",
                "data": bits.tobytes()}
    if isinstance(obj, torch.Tensor):
        obj = obj.detach().cpu().numpy()
    if isinstance(obj, np.ndarray):
        return {"__nd__": list(obj.shape), "dtype": str(obj.dtype),
                "data": obj.tobytes()}
    if isinstance(obj, dict):
        return {"__map__": {k: _encode(obj[k]) for k in sorted(obj)}}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": [_encode(v) for v in obj],
                "tuple": isinstance(obj, tuple)}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return {"__leaf__": obj}
    raise TypeError(f"cannot checkpoint {type(obj)}")


def _decode(obj: Any):
    if "__nd__" in obj:
        if obj["dtype"] == "bfloat16":
            bits = np.frombuffer(obj["data"], dtype=np.uint16)
            return torch.from_numpy(bits.reshape(obj["__nd__"])).view(
                torch.bfloat16)
        arr = np.frombuffer(obj["data"], dtype=np.dtype(obj["dtype"]))
        return arr.reshape(obj["__nd__"])
    if "__map__" in obj:
        return {k: _decode(v) for k, v in obj["__map__"].items()}
    if "__seq__" in obj:
        seq = [_decode(v) for v in obj["__seq__"]]
        return tuple(seq) if obj.get("tuple") else seq
    return obj["__leaf__"]


def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (tensors, numpy arrays, dicts, lists, tuples and
    scalars) to ``path`` atomically."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    chunks = _msgpack.pack_chunks(_encode(tree))
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            f.writelines(chunks)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def restore_pytree(path: str) -> Any:
    """The tree of ``path``, its arrays numpy views of one buffer."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path} changed size while being read")
    return _decode(_msgpack.unpackb(buf))


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(ckpt_dir)
             if (m := re.match(r"step_(\d+)\.msgpack$", f))]
    return max(steps) if steps else None


def save_federation(ckpt_dir: str, fed, step: int, bus=None,
                    clients=None) -> None:
    """Persist the federation: every cohort's params and optimizer state,
    the server state, the wire codec names, the targets, and the port's
    generator state. ``bus`` (a ``ServerBus``) adds the trigger and
    staleness bookkeeping; ``clients`` (a ``ClientRuntime``) its inner-
    step count and the clients ever woken. A sharded cohort writes its
    real rows only, so the file is the unsharded run's and restores onto
    any mesh or none."""
    own = {"generator": fed.generator.get_state().numpy(),
           "generator_device": fed.generator.device.type}
    if clients is not None:
        own["client_step"] = int(clients.step)
        own["ever_woken"] = np.array(clients.ever_woken, bool)
    tree = {
        "server": fed.server._asdict(),
        "zoo": [c.family_name for c in fed.cohorts],
        "cohorts": [{
            "family": c.family_name,
            "client_ids": np.asarray(c.client_ids),
            "params": tensors_to_numpy(c.module,
                                       list(c.real_params.values())),
            "opt_state": {"__nt__": type(c.real_opt_state).__name__,
                          **opt_state_to_numpy(c.module, c.real_opt_state)},
        } for c in fed.cohorts],
        "wire": {"uplink": fed.uplink, "downlink": fed.downlink},
        "round": step,
        "torch": own,
    }
    if fed.targets is not None:
        tree["targets"] = fed.targets
    if bus is not None:
        tree["bus"] = bus.state_dict()
    save_pytree(os.path.join(ckpt_dir, f"step_{step}.msgpack"), tree)


def _check_zoo(tree, fed) -> None:
    saved = [s["family"] for s in tree["cohorts"]]
    live = [c.family_name for c in fed.cohorts]
    if saved == live:
        return
    missing = [f for f in saved if f not in live]
    extra = [f for f in live if f not in saved]
    detail = []
    if missing:
        detail.append(f"checkpoint families missing from the live zoo: "
                      f"{missing}")
    if extra:
        detail.append(f"live families absent from the checkpoint: {extra}")
    if not detail:
        detail.append("cohort order changed")
    raise ZooMismatchError(
        f"cohort layout changed: checkpoint has {saved}, live federation "
        f"has {live} — {'; '.join(detail)}")


def restore_federation(ckpt_dir: str, fed, step: Optional[int] = None,
                       bus=None, clients=None) -> int:
    """Restore in place from the port's or the reference's file; cohort
    order and families must match (``ZooMismatchError`` otherwise, before
    anything is assigned). Legacy files restore as ``dense32``; a file
    without ``div_cache`` gets it rebuilt from the repository (Eq. 2 on
    the federation's device); a file without a ``bus`` section zeroes the
    given bus's counters; files without targets leave them untouched. A
    sharded cohort takes the file's rows ghost-padded again. Returns the
    step."""
    from repro_torch.core.server import ServerState
    from repro_torch.core.wire import as_codec
    from repro_torch.kernels import ops
    step = step if step is not None else latest_step(ckpt_dir)
    tree = restore_pytree(os.path.join(ckpt_dir, f"step_{step}.msgpack"))
    _check_zoo(tree, fed)
    codecs = tree.get("wire") or {}
    uplink = codecs.get("uplink", "dense32")
    downlink = codecs.get("downlink", "dense32")
    as_codec(uplink), as_codec(downlink)     # names must resolve
    dev = fed.device

    def on_device(arr) -> torch.Tensor:
        return torch.from_numpy(arr).to(dev, copy=True)

    server = {k: on_device(v) for k, v in tree["server"].items()}
    if "div_cache" not in server:
        # a file from before the delta path: rebuild the divergence cache
        # of the restored repository, so incremental updates stay exact
        server["div_cache"] = ops.pairwise_kl(server["repo_logp"])
    # convert (and shape-check) every cohort's real rows before
    # assigning anything
    loaded = [(tensors_from_numpy(c.module, saved["params"],
                                  list(c.real_params.values())),
               opt_state_from_numpy(
                   c.module, {k: v for k, v in saved["opt_state"].items()
                              if k != "__nt__"}, c.real_opt_state))
              for c, saved in zip(fed.cohorts, tree["cohorts"])]
    fed.server = ServerState(**server)
    fed.uplink, fed.downlink = uplink, downlink
    if "targets" in tree:
        fed.targets = on_device(tree["targets"])
    for c, (params, opt_state) in zip(fed.cohorts, loaded):
        repad_cohort_arrays(c, params, opt_state)
    if bus is not None:
        bus.load_state_dict(tree.get("bus"))
    own = tree.get("torch")
    if own is not None and own["generator_device"] == fed.generator.device.type:
        fed.generator.set_state(torch.from_numpy(np.array(own["generator"])))
    if clients is not None:
        if own is not None and "client_step" in own:
            clients.step = int(own["client_step"])
            clients.ever_woken = np.array(own["ever_woken"], bool)
        else:
            clients.step = int(tree["round"]) * clients.config.local_steps
    return step
