"""The neural building blocks and the training loop of the baselines."""

from insite_tpu_torch.models.nn.blocks import (BRTreatmentOutcomeHead,
                                               ROutcomeVitalsHead,
                                               TransformerDecoderBlock,
                                               TransformerEncoderBlock,
                                               TransformerMultiInputBlock,
                                               VariationalLSTM, grad_reverse)

__all__ = ['BRTreatmentOutcomeHead', 'ROutcomeVitalsHead', 'VariationalLSTM',
           'TransformerMultiInputBlock', 'TransformerEncoderBlock',
           'TransformerDecoderBlock', 'grad_reverse']
