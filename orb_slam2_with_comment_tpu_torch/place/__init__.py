# train_vocabulary, bow_vectors and score_l1 are not ported yet
from .vocabulary import Vocabulary, transform  # noqa: F401
from .database import KeyFrameDatabase  # noqa: F401
