from .gpt import GPTConfig, GPT, ByteTokenizer
from .decoding import KVFns, ParamFn, generate_batch
from .bert import BertConfig, BertModel, BertForMaskedLM
