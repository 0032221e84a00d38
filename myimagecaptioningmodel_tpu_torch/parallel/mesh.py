"""The data-parallel group, described as the JAX package's mesh describes
its devices; the counterpart of ``myimagecaptioningmodel_tpu/parallel/mesh.py``
along its data axis.

In the JAX package a ``Mesh`` of (data, model) axes carries the sharding,
and GSPMD inserts the gradient ``psum``. In the port each process owns one
device and its rows of every global batch: ``make_mesh`` names the group
(its size, this process's rank and device; the training loop and
``evaluate`` take theirs from it, as the JAX package's do) and
``shard_batch`` takes this rank's rows. The vocab tensor parallelism of the
``model`` axis (``param_shardings``, ``opt_state_shardings``) is not ported
yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from myimagecaptioningmodel_tpu_torch.parallel import distributed

DATA_AXIS = "data"
MODEL_AXIS = "model"


class DataMesh(NamedTuple):
    """The data-parallel group as this process sees it."""

    size: int  # processes, one device each
    rank: int  # this process's place among them
    device: torch.device  # this process's device

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.size, MODEL_AXIS: 1}


def make_mesh(device: Optional[torch.device] = None, model_parallel: int = 1) -> DataMesh:
    """The data-parallel group of the current process group (one process
    outside one); ``device`` defaults to this process's GPU."""
    if model_parallel > 1:
        raise NotImplementedError(
            "model_parallel > 1 (vocab tensor parallelism) is not ported yet: ROADMAP.md "
            "queue 1, vocab TP")
    if device is None:
        device = distributed.local_device()
    return DataMesh(distributed.process_count(), distributed.process_index(),
                    torch.device(device))


def shard_batch(mesh: DataMesh, *arrays):
    """This rank's rows of each global host batch, on the mesh's device."""
    out = tuple(torch.as_tensor(distributed.local_rows(a)).to(mesh.device) for a in arrays)
    return out if len(out) > 1 else out[0]
