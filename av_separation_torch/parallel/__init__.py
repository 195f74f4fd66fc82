"""The parallel tier (port of `av_separation_tpu/parallel/`): the mesh
and its placement rules, collectives with their gradient rules, the
sharding of a model and its gradients, multi-process start-up and
sequence parallelism, over `torch.distributed` (NCCL on the card, gloo
on the CPU)."""
