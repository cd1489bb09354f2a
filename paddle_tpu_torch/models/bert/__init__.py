from .modeling import (  # noqa: F401
    BertConfig,
    BertForMaskedLM,
    BertForSequenceClassification,
    BertModel,
)
