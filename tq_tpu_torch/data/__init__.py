from tq_tpu_torch.data.mnist import load_mnist
from tq_tpu_torch.data.synthetic import synthetic_mnist

__all__ = ["load_mnist", "synthetic_mnist"]
