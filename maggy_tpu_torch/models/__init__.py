from maggy_tpu_torch.models.bert import BertConfig, BertEncoder, flax_to_state_dict
from maggy_tpu_torch.models.llama import Llama, LlamaConfig, LoRADense, rope

__all__ = ["BertConfig", "BertEncoder", "Llama", "LlamaConfig", "LoRADense",
           "flax_to_state_dict", "rope"]
