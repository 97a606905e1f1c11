from .from_jax import (flax_to_state_dict, sa_module_msg_state_dict,
                       group_all_state_dict, lfp_module_msg_state_dict,
                       points_obj_cls_state_dict, mha_state_dict)

__all__ = ["flax_to_state_dict", "sa_module_msg_state_dict",
           "group_all_state_dict", "lfp_module_msg_state_dict",
           "points_obj_cls_state_dict", "mha_state_dict"]
