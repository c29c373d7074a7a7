"""Tensor, data and expert parallelism on torch.distributed — counterpart of
csinn2_tpu/parallel/: mesh.py (init_distributed, Mesh, make_mesh,
make_multihost_mesh, the two collectives), tp.py (local_config,
param_specs, shard_llama_params, tp_llama_forward), ep.py (ep_param_specs,
shard_moe_params, ep_llama_forward), and launch.py (spawn: a function on a
fresh group of local processes).  The modules are imported by name: llm/
imports mesh.py, and tp.py and ep.py import llm/."""
