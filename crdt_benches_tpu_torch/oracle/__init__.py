from .text_oracle import OracleDocument, replay_trace, replay_unit_ops

__all__ = ["OracleDocument", "replay_trace", "replay_unit_ops"]
