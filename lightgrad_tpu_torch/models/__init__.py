from .gpt import GPTConfig, GPT, ByteTokenizer, GPT2Tokenizer
from .decoding import (KVFns, ParamFn, beam_search, generate_batch,
                       generate_speculative, generate_speculative_device)
from .bert import BertConfig, BertModel, BertForMaskedLM, BertTokenizer
from .llama import Llama, LlamaConfig, LlamaTokenizer, RMSNorm
from .neox import NeoX, NeoXConfig
from .resnet import (BasicBlock, ResNet, load_torchvision_state_dict,
                     resnet18, resnet20)
from .vit import ViTConfig, ViTModel, ViTForImageClassification
from .diffusion import UNet, Diffusion
from .t5 import T5Config, T5ForConditionalGeneration
