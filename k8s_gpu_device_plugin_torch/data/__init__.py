"""data of the PyTorch/CUDA port (mirrors k8s_gpu_device_plugin_tpu/data)."""
