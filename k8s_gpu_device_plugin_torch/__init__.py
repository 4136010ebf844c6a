"""PyTorch/CUDA port of the serving and training stacks, for NVIDIA Hopper
(sm_90a).

The JAX package ``k8s_gpu_device_plugin_tpu`` is the reference; this
package mirrors its subpackage layout and module names so each piece
has an obvious counterpart, and it imports nothing of it (nor JAX).

Every entry point runs on ``cuda`` unless the caller asks for the CPU
(``device="cpu"`` / ``--device cpu``); asking for CUDA where there is
none raises (:func:`k8s_gpu_device_plugin_torch.device.resolve_device`).
Each kernel the reference wrote in Pallas is a hand-written CUDA kernel
here (``ops/csrc``); its plain PyTorch version lives beside its wrapper
and is taken only for tensors that lie on the CPU.
"""
