from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaDecoderLayer, LlamaAttention, LlamaMLP)
