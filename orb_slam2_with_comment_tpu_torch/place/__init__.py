from .vocabulary import (Vocabulary, bow_vectors, score_l1,  # noqa: F401
                         train_vocabulary, transform)
from .database import KeyFrameDatabase  # noqa: F401
