from .llama import (LlamaConfig, LlamaForCausalLM, LlamaModel,  # noqa: F401
                    LlamaDecoderLayer, LlamaAttention, LlamaMLP,
                    LlamaPretrainingCriterion)
from .gpt import (GPTConfig, GPTForCausalLM, GPTModel,  # noqa: F401
                  GPTDecoderLayer, GPTAttention, GPTEmbeddings)
from .bert import (BertConfig, BertEmbeddings, BertModel,  # noqa: F401
                   BertForMaskedLM, BertForSequenceClassification)
from .train_step import SpmdTrainer  # noqa: F401
