"""The benchmark's plain reference: the network, FastDPM and the two
training losses in plain PyTorch, float32, with no kernel, graph or fused
route.

``net/`` is a frozen copy of the PyTorch port's modules at commit
``fddce06`` (``models/{common,attention,condition_net,modules,grouping,
pnet,model_config,upsample}.py``, ``ops/{neighbors,sampling,ball_group,
interpolate,scatter,chamfer}.py``, ``diffusion/{schedule,fastdpm}.py``,
``utils/device.py``), with its imports made relative to the copy.  It
imports nothing of the port, of the JAX package or of JAX.  Departures
from the copied files:

- ``ops/{neighbors,sampling,ball_group,scatter}.py`` keep only their plain
  versions: each public op calls its ``*_plain`` body, and the kernel
  dispatch (``ops/kernels.py``, launches, lane and block choices, the
  ordered gather's kernel backward, the atomic scatter) is gone;
- ``models/attention.py``: the fused attention pool's route computes the
  unfused pool's math and calls ``FUSED_POOL_HOOKS`` (the benchmark's
  count of the work the program's pool kernels do);
  ``_fused_weights`` and the import of ``ops/attention_pool.py`` are gone;
- ``models/common.py``, ``models/attention.py``: a Dense or SplitDense
  with ``fp8 = True`` rounds its input, kernel and output to float8 e4m3
  under per-tensor scales and multiplies in float32, and rounds the
  gradients flowing back through those points to float8 e5m2, as fp8
  training does (the control of the correctness check: fp8 where the
  configuration computes in bf16); off by default;
- ``diffusion/fastdpm.py``: the captured-graph sampler and its import of
  ``utils/graphs.py`` are gone; ``DenoiseFn`` is defined in place.

``model.py`` builds the reference network in a given precision and runs
the computations the benchmark compares: FastDPM from given x_T and noise,
and training steps from given batches, t and z with a plain Adam.
"""
