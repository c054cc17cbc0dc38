from .gpt import GPTConfig, GPT, ByteTokenizer
from .decoding import KVFns, ParamFn, generate_batch
