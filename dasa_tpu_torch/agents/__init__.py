from dasa_tpu_torch.agents.seq2seq import Seq2SeqAgent  # noqa: F401
