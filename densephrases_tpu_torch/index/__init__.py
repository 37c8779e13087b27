from densephrases_tpu_torch.index.store import PhraseStore, DocMeta, StoreWriter
from densephrases_tpu_torch.index.flat import FlatIndex
from densephrases_tpu_torch.index.ivf import IVFConfig, IVFIndex
from densephrases_tpu_torch.index.sharded import MeshShardedIVF, ShardedIVF
from densephrases_tpu_torch.index.tiered import TieredFlatIndex, TieredIVF
from densephrases_tpu_torch.index.search import MIPS
