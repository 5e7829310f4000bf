from autodist_tpu_torch.models.gpt import GPT, GPT_SMALL, GPT_TINY, GPTConfig, gpt_loss

__all__ = ["GPT", "GPT_SMALL", "GPT_TINY", "GPTConfig", "gpt_loss"]
