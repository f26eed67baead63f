from .synth import bernoulli_db, census_like_db
