"""Host plans, tensor ops and the omnibus kernel of the torch port."""
