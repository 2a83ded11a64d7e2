"""A serving rank's decode-cache bytes under the port's mesh layout, beside
the planner's per-device estimate.

    PYTHONPATH=src python scripts/serve_layout_bytes.py

For each architecture at ``decode_32k`` (B 128, S 32,768) on data x model
meshes of the H100 node (1 x 8, 2 x 4) and of the production mesh (16 x
16), prints rank 0's cache bytes as ``train.step_builder.serve_layout``
lays it out (its slots and heads: ``serve.paging.cache_partition_bytes``
of the resident cache) and ``core.serve_plan.cache_bytes_per_device``,
the reference's layout, which splits the sequence over the model axis
where ranks share a KV head. Their ratio is what the port's layout holds
above the planner's estimate. Needs no device: only shapes are read.
"""
from __future__ import annotations

import json

import torch

from repro_torch.configs import ARCHS, get_config, get_shape
from repro_torch.core.hardware import MeshSpec
from repro_torch.core.plan import MemoryPlan
from repro_torch.core.serve_plan import cache_bytes_per_device
from repro_torch.launch.mesh import LocalMesh
from repro_torch.models.model import num_repeats
from repro_torch.serve.paging import cache_partition_bytes
from repro_torch.train.step_builder import serve_layout

MESHES = ((1, 8), (2, 4), (16, 16))


def main() -> None:
    shape = get_shape("decode_32k")
    for arch in ARCHS:
        cfg = get_config(arch)
        n = num_repeats(cfg)
        plan = MemoryPlan(n + 2, n, n_persist=n + 2)
        for data, model in MESHES:
            mesh = LocalMesh(0, data * model, None, torch.device("cpu"), model=model)
            lay = serve_layout(cfg, plan, shape, None, mesh)
            rank = cache_partition_bytes(cfg, lay.slots[1], shape.seq_len, None, lay.tp)["hbm"]
            est = cache_bytes_per_device(cfg, shape, MeshSpec((data, model), ("data", "model")))
            print(json.dumps({"arch": arch, "mesh": [data, model], "slots_rank": lay.slots[1],
                              "cache_bytes_rank": rank, "serve_plan_bytes": est,
                              "ratio": rank / est}))


if __name__ == "__main__":
    main()
