from .gpt import GPTConfig, GPT, ByteTokenizer
from .decoding import KVFns, ParamFn, generate_batch
from .bert import BertConfig, BertModel, BertForMaskedLM
from .llama import Llama, LlamaConfig, LlamaTokenizer, RMSNorm
from .neox import NeoX, NeoXConfig
from .resnet import (BasicBlock, ResNet, load_torchvision_state_dict,
                     resnet18, resnet20)
