from maggy_tpu_torch.models.bert import BertConfig, BertEncoder, flax_to_state_dict
from maggy_tpu_torch.models.llama import Llama, LlamaConfig, LoRADense, rope
from maggy_tpu_torch.models.mnist_cnn import MnistCNN, MnistMLP
from maggy_tpu_torch.models.moe import MoEMLP
from maggy_tpu_torch.models.resnet import ResNet
from maggy_tpu_torch.models.surgery import AblatableSequential, ablatable_model_generator
from maggy_tpu_torch.models.vit import ViT, ViTConfig

__all__ = ["AblatableSequential", "BertConfig", "BertEncoder", "Llama", "LlamaConfig", "LoRADense", "MnistCNN",
           "MnistMLP", "MoEMLP", "ResNet", "ViT", "ViTConfig", "ablatable_model_generator",
           "flax_to_state_dict", "rope"]
