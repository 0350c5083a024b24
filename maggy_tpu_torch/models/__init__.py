from maggy_tpu_torch.models.bert import BertConfig, BertEncoder, flax_to_state_dict

__all__ = ["BertConfig", "BertEncoder", "flax_to_state_dict"]
