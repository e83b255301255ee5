"""Debug-run validation: id-range and non-finite checks around the loss."""

from graphqembed_tpu_torch.utils.debug import checked_margin_loss, validate_ids  # noqa: F401
