"""fluid.layers (counterpart of ``paddle_tpu/fluid/layers.py``): the
reader path's four names, and the detection family with ``yolo_box``,
``yolov3_loss`` (``vision.ops.yolo_loss``) and ``detection_output``,
whose outputs keep the fixed-shape contract (rows padded with label -1,
not LoD).  The rest of the fluid op spelling raises, naming ROADMAP
Queue 1 item 4."""
from ..vision.detection import (  # noqa: F401
    anchor_generator, bipartite_match, box_clip, box_coder,
    collect_fpn_proposals, density_prior_box, distribute_fpn_proposals,
    generate_proposal_labels, iou_similarity, matrix_nms, multi_box_head,
    multiclass_nms, polygon_box_transform, prior_box,
    retinanet_detection_output, retinanet_target_assign,
    roi_perspective_transform, ssd_loss, target_assign)
from ..vision.ops import yolo_box  # noqa: F401
from ..vision.ops import yolo_loss as yolov3_loss  # noqa: F401
from ._facade import not_ported
from .reader_compat import (create_py_reader_by_data,  # noqa: F401
                            double_buffer, py_reader, read_file)

__getattr__ = not_ported(__name__)


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0,
                     return_index=False):
    """SSD's inference head: decode ``loc`` [B, N, 4] against the priors
    and ``multiclass_nms`` over ``scores`` [B, N, C].  As in the
    reference (``paddle_tpu/fluid/layers_ext.py``), the scores are taken
    after the softmax (Paddle's fluid applies it itself), and ``nms_eta``
    and ``return_index`` are not passed on.  Returns [B, keep_top_k, 6]
    rows, label -1 on padding."""
    from ..tensor.manipulation import transpose
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size", axis=0)
    return multiclass_nms(decoded, transpose(scores, [0, 2, 1]),
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, keep_top_k=keep_top_k,
                          nms_threshold=nms_threshold,
                          background_label=background_label)
