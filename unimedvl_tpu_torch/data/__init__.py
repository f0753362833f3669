"""Host-side data helpers of the port: image preprocessing (PIL and numpy)
and special-token registration. ``imaging`` imports PIL, so it is imported
where an image is handled, not here."""
