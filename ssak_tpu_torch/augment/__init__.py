from ssak_tpu_torch.augment.specaugment import spec_augment
from ssak_tpu_torch.augment.speech import SpeechAugment

__all__ = ["SpeechAugment", "spec_augment"]
