"""PyTorch model zoo: WGAN generator and critic, encoder and classifiers
A-F."""

from defensegan_torch.models.classifiers import (CLASSIFIER_ZOO,
                                                 build_classifier)
from defensegan_torch.models.critic import Critic, critic_for
from defensegan_torch.models.encoder import Encoder, encoder_for
from defensegan_torch.models.generator import (Generator, from_image_space,
                                               generator_for, to_image_space)

__all__ = ["CLASSIFIER_ZOO", "build_classifier", "Critic", "critic_for",
           "Encoder", "encoder_for",
           "Generator", "generator_for", "from_image_space",
           "to_image_space"]
