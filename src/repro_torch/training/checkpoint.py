"""Checkpoints: the port's params and AdamW state <-> a flat ``.npz`` in
the reference's key layout (``src/repro/training/checkpoint.py``), so each
package loads the other's files:

* ``params/<path>`` — the parameter tree with the layers stacked on a
  leading axis in one group (``convert.to_flat``), f32;
* ``opt/.step`` (int32), ``opt/.mu/<path>`` and ``opt/.nu/<path>`` — the
  reference's ``AdamWState`` NamedTuple, whose field names its tree paths
  render as ``.mu``;
* ``meta/step``.

A sharded run saves the full trees (``save(..., specs=)``), so its file
is the same as an unsharded run's.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from repro_torch.convert import from_flat, to_flat
from repro_torch.parallel import ctx
from repro_torch.parallel.sharding import gather_tree
from repro_torch.training.optimizer import AdamWState


def save(path: str, params: dict, opt_state: Optional[AdamWState] = None,
         step: int = 0, specs=None) -> None:
    """Write ``params`` (and ``opt_state``) to ``path``.  ``specs``: they
    are this rank's shards under the active mesh (the training layout's
    spec tree): every rank gathers the full trees (a collective: each
    rank calls ``save``), and the mesh's rank 0 writes them."""
    if specs is not None:
        params = gather_tree(params, specs)
        if opt_state is not None:
            opt_state = opt_state._replace(
                mu=gather_tree(opt_state.mu, specs),
                nu=gather_tree(opt_state.nu, specs))
        if ctx.active().rank != 0:
            return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"params/{k}": v for k, v in to_flat(params).items()}
    if opt_state is not None:
        payload["opt/.step"] = np.asarray(opt_state.step, np.int32)
        for field in ("mu", "nu"):
            payload.update({f"opt/.{field}/{k}": v for k, v in
                            to_flat(getattr(opt_state, field)).items()})
    payload["meta/step"] = np.asarray(step)
    np.savez_compressed(path, **payload)


def load(path: str, device="cuda"
         ) -> Tuple[dict, Optional[AdamWState], int]:
    """``(params, opt_state or None, step)`` on ``device``, all f32 (the
    trainer's masters and moments)."""
    with np.load(path) as z:
        data = {k: z[k] for k in z.files}

    def tree(prefix: str) -> dict:
        flat = {k[len(prefix):]: v for k, v in data.items()
                if k.startswith(prefix)}
        return from_flat(flat, device=device)

    params = tree("params/")
    opt = None
    if "opt/.step" in data:
        opt = AdamWState(step=int(data["opt/.step"]), mu=tree("opt/.mu/"),
                         nu=tree("opt/.nu/"))
    return params, opt, int(data["meta/step"])
