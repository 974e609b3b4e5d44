from tq_tpu_torch.data.mnist import load_mnist
from tq_tpu_torch.data.synthetic import (synthetic_imagenet_batch,
                                         synthetic_mnist, synthetic_tokens)
from tq_tpu_torch.data.wikitext import batchify, load_corpus

__all__ = ["load_mnist", "synthetic_mnist", "synthetic_imagenet_batch",
           "synthetic_tokens", "load_corpus", "batchify"]
