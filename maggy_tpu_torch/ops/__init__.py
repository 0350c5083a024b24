"""Hand-written GPU kernels and the tensor ops around them."""

from maggy_tpu_torch.ops.losses import (chunked_next_token_loss, chunked_softmax_xent,
                                        next_token_labels, next_token_loss,
                                        sharded_next_token_loss)

__all__ = ["chunked_next_token_loss", "chunked_softmax_xent", "next_token_labels",
           "next_token_loss", "sharded_next_token_loss"]
