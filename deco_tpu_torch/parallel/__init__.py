"""Parallel execution of the port (``deco_tpu/parallel/``): the process
group, the (data, model) mesh, ring attention, the sequence-, tensor- and
pipeline-parallel trunk executors and the expert-parallel MoE layer."""
