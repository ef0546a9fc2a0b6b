"""Special vocabulary tokens (reference dataset/constant/tokens.py:1-4)."""

BOS_WORD = "<bos>"
EOS_WORD = "<eos>"
UNK_WORD = "<unk>"
PAD_WORD = "<pad>"
