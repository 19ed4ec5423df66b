from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaDecoderLayer, LlamaAttention, LlamaMLP,
                    LlamaPretrainingCriterion)
from .train_step import SpmdTrainer  # noqa: F401
