"""Tensor, data, expert, context and pipeline parallelism on
torch.distributed — counterpart of csinn2_tpu/parallel/: mesh.py
(init_distributed, Mesh, make_mesh, make_multihost_mesh, the two
collectives, a broadcast, and the point-to-point helpers neighbour / shift /
send / recv_into), tp.py (local_config, param_specs, shard_llama_params,
tp_llama_forward), ep.py (ep_param_specs, shard_moe_params,
ep_llama_forward), cp.py (ring_attention over sequence shards,
ring_attention_reference, shard_sequence / gather_sequence), pp.py
(PipelinedLlama, host-stepped over a device list; SPMDPipelinedLlama, the
GPipe tick loop over a (pp[, tp]) mesh), and launch.py (spawn: a function
on a fresh group of local processes).  The modules are imported by name:
llm/ imports mesh.py, and tp.py, ep.py and pp.py import llm/."""
