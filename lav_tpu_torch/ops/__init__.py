"""Point painting, the pillar featurizer and peak decoding."""
