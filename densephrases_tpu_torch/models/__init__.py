# The towers are nn.Modules: ``BertModel`` stands where the reference
# exports the functional ``init_bert_params`` and ``bert_forward``.
from densephrases_tpu_torch.models.bert import BertConfig, BertModel
from densephrases_tpu_torch.models.encoder import PhraseEncoder
