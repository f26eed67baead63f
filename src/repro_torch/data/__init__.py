from .pipeline import TokenPipeline, TransactionPipeline
from .synth import bernoulli_db, census_like_db, token_stream
