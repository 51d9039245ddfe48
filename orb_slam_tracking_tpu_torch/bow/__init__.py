"""Bag-of-words place recognition (counterpart of ``bow``): the vocabulary
tree and the keyframe database."""
