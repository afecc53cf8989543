"""Codistillation core: losses, schedules, exchange plans, comm accounting."""
