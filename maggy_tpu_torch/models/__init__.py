from maggy_tpu_torch.models.bert import BertConfig, BertEncoder, flax_to_state_dict
from maggy_tpu_torch.models.llama import Llama, LlamaConfig, LoRADense, rope
from maggy_tpu_torch.models.mnist_cnn import MnistCNN, MnistMLP

__all__ = ["BertConfig", "BertEncoder", "Llama", "LlamaConfig", "LoRADense", "MnistCNN",
           "MnistMLP", "flax_to_state_dict", "rope"]
