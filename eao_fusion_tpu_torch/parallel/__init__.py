"""The distributed layer (port of `eao_fusion_tpu/parallel/`): process
groups over `torch.distributed`, the device mesh, the observation-sharded
global BA and its server, and data-parallel evaluation."""
