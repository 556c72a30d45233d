"""Host tools of the port (numpy only; nothing runs on the card)."""
