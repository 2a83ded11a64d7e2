"""Distributed substrate of the port on ``torch.distributed``.

``repro_torch.dist.sharding`` says how a ``ParamDef`` leaf shards over the
data extent under a MemoryPlan's placement; ``repro_torch.dist.collectives``
holds the gradient-sync primitives (bf16 cast, int8 + error feedback, the
compressed reduce-scatter and the lazy ZeRO-3 gather).
"""
