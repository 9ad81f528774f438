"""Kernels of the port: ``fused_stencil`` (K1 on Hopper, the counterpart
of ``yask_tpu/ops/pallas_stencil.py``), its emitter ``cuda_emit`` and the
nvcc build ``_build``.  Importing builds nothing."""
