from densephrases_tpu_torch.data.tokenization import (
    WordPieceTokenizer,
    train_wordpiece_vocab,
)
from densephrases_tpu_torch.data.features import (
    ContextFeatures,
    QuestionFeatures,
    convert_context_to_features,
    convert_questions_to_features,
)
