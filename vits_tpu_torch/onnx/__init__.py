"""ONNX interchange export of the port (counterpart of vits_tpu/onnx): the
dependency-free protobuf writer (`proto`), the ExportedProgram -> ONNX
translator (`convert`), the two-phase export (`export_model`) and an
evaluator on torch tensors (`runtime`). See export_model.export_onnx."""

from vits_tpu_torch.onnx.export_model import export_onnx, export_p1, export_p2  # noqa: F401
