from ray_tpu_torch.accelerators.gpu import GPUAcceleratorManager

__all__ = ["GPUAcceleratorManager"]
